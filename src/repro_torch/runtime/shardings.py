"""Sharding profiles: how DP, FSDP, TP, EP and SP map onto the mesh axes,
after ``repro.runtime.shardings``.

Axes (``launch/mesh.py``):
  single-pod  (n/8, 8)    -> ("data", "model")
  multi-pod   (2, n/16, 8) -> ("pod", "data", "model")

The model axis is one NVLink domain of 8 cards.  The profile is
MaxText-style 2D/3D sharding:
  - DP/FSDP over ("pod", "data"): batch and parameter/optimizer-state
    storage (ZeRO-3: the parameters are gathered layer by layer).
  - TP over "model": attention heads, MLP hidden, vocab, experts (EP).
  - SP over "model": the sequence dim of activations at layer
    boundaries (Megatron-SP style), and of the KV cache for long-context
    decode when the KV heads do not divide the model axis.

A spec is a :class:`P`: one entry per leading tensor dim, each an axis
name, a tuple of axis names (one tensor dim over several mesh dims,
major to minor) or ``None`` (replicated); a spec shorter than its
tensor's rank leaves the trailing dims replicated.
:func:`to_placements` turns one into the ``torch.distributed.tensor``
placements of a ``DeviceMesh``, and :func:`local_shard` cuts a rank's
shard of a whole tensor.

On a profile with a mesh the model runs SPMD, one process per card, and
:class:`Place` is a rank's place on it for one call: its blocks of the
batch (over the data axes) and of the sequence (over the model axis),
and the collectives that cross ranks, each a :class:`Across` step with
its adjoint.  Under ``pure_dp`` the model axis is one more batch and
FSDP axis and the tensor-parallel group is :data:`SOLO`, a group of one
process, so every tensor-parallel step is the identity there.  Without
a mesh the place is :data:`ALONE`, whose blocks are the whole and whose
steps are the identity, so one body of each model function serves both
(:func:`place_of`).  The reference's ``cons`` constraints become those
steps
(``models/lm.py``): the sequence gathered at each sublayer's entry and
reduce-scattered at its exit (Megatron-SP), the ZeRO gather of FSDP
shards, the embedding and the logits by vocab block.
Every sum over ranks goes through the fixed-ring ``ordered_ring_reduce``
(a reduce-scatter is that sum, then the rank's block), so a result is
bitwise the same whatever the ranks' timing; ``cons`` itself stays the
identity on a mesh of one device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.optim.ordered_reduce import ordered_ring_reduce
from repro_torch.tree import flatten_up_to, leaves, unflatten


class P(tuple):
    """A partition spec: a tuple of axis names, tuples of axis names and
    ``None``s, printed as the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(tuple(self))}"


@dataclasses.dataclass(frozen=True)
class Profile:
    """Activation/parameter spec factory for one mesh shape."""

    data_axes: tuple = ("data",)      # ("pod", "data") when multi-pod
    model_axis: str = "model"
    enabled: bool = True              # False -> no constraints (smoke)
    fsdp: bool = True                 # shard params over data axes too
    seq_shard: bool = True            # SP at layer boundaries
    replicated_batch: bool = False    # batch too small to shard
    mesh: object = None               # the DeviceMesh, where one exists
    pure_dp: bool = False             # the model axis as extra data:
    # FSDP over every card, no TP/SP, so no activation gathers or
    # partial-sum reductions

    @property
    def da(self):
        if self.replicated_batch:
            return None
        if self.pure_dp:
            return tuple(self.data_axes) + (self.model_axis,)
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def ma(self):
        if self.pure_dp:
            return None               # activations never use the TP axis
        return self.model_axis

    # ---- activations ----
    def act_btd(self) -> P:           # (B, S, D) at block boundaries
        return P(self.da, self.ma if self.seq_shard else None, None)

    def act_gathered(self) -> P:      # (B, S, D) sublayer entry: the SP
        # all-gather before column-parallel projections (Megatron-SP)
        return P(self.da, None, None)

    def act_bthd(self) -> P:          # (B, S, H*hd) flat, pre-head-split
        return P(self.da, None, self.ma)

    def act_btf(self) -> P:           # (B, S, F) MLP hidden
        return P(self.da, None, self.ma)

    def act_btv(self) -> P:           # (B, S, V) logits: vocab over TP
        return P(self.da, None, self.ma)

    def batch(self) -> P:             # (B, S) tokens
        return P(self.da, None)

    # ---- parameters (never affected by replicated_batch) ----
    def _fs(self, axis):
        if not self.fsdp:
            return None
        if self.pure_dp:
            return tuple(self.data_axes) + (self.model_axis,)
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def embed(self) -> P:             # (V, D): vocab over the model axis
        return P(self.model_axis, None)

    def head(self) -> P:              # (D, V)
        return P(None, self.model_axis)

    def w_in(self) -> P:              # (D, F) / (D, H*hd)
        if self.pure_dp:
            return P(self._fs(0), None)
        return P(self._fs(0), self.ma)

    def w_out(self) -> P:             # (F, D) / (H*hd, D)
        if self.pure_dp:
            return P(None, self._fs(1))
        return P(self.ma, self._fs(1))

    def bias_ff(self) -> P:           # (F,)
        return P(self.ma)

    def experts_in(self) -> P:        # (E, D, F): EP over model, FSDP
        # storage over data on D
        return P(self.model_axis, self._fs(1), None)

    def experts_out(self) -> P:       # (E, F, D): F over data either way
        return P(self.model_axis, self._fs(1), None)

    def vector(self) -> P:            # (D,) norm scales
        return P(None)

    # ---- KV cache (decode) ----
    def cache_kv(self, n_kv: int, model_size: int) -> P:
        # (B, S, KV, hd): shard KV heads over model when divisible,
        # else shard the sequence (context parallelism for long decode).
        if n_kv % model_size == 0 and n_kv >= model_size:
            return P(self.da, None, self.ma, None)
        return P(self.da, self.ma, None, None)


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def cons(x, spec: P, profile: Profile, barrier: bool = False):
    """``x`` constrained to ``spec`` on the profile's mesh: the identity
    when the profile is disabled or its mesh has one device, else a
    DTensor ``x`` redistributed to the spec's placements.

    ``barrier`` (the reference pins the reshard to the value's dtype
    with an optimization barrier, since XLA can move dtype converts
    across collectives) has no counterpart here: a redistribute moves
    the tensor in the dtype it has."""
    del barrier
    if not profile.enabled or _mesh_size(profile.mesh) == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("cons on a mesh of several devices takes a DTensor, "
                        f"got {type(x).__name__}")
    return x.redistribute(profile.mesh,
                          to_placements(spec, profile.mesh, x.ndim))


SMOKE = Profile(enabled=False)


def norm_spec(spec, ndim: int) -> tuple:
    """``spec`` padded with ``None`` to ``ndim`` entries."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def axis_names(entry) -> tuple:
    """The mesh axes of one spec entry: an axis name, a tuple of them or
    ``None`` (none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_dims(spec, names, ndim: int) -> list:
    """For each mesh dim (of axis names ``names``), the tensor dim that
    ``spec`` shards over it, or None.  A tuple entry takes its axes in
    the mesh's order, the first the most major."""
    owner = [None] * len(names)
    for dim, entry in enumerate(norm_spec(spec, ndim)):
        axes = axis_names(entry)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {spec}: axis not in the mesh {names}")
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            if owner[i] is not None:
                raise ValueError(f"spec {spec}: mesh axis {names[i]} twice")
            owner[i] = dim
    return owner


def to_placements(spec, mesh, ndim: int) -> tuple:
    """The ``torch.distributed.tensor`` placements, one per mesh dim of
    ``mesh``, of a tensor of ``ndim`` dims laid out by ``spec``:
    ``Shard(d)`` where the spec names that mesh dim's axis at tensor dim
    d, ``Replicate()`` elsewhere.  One tensor dim over several mesh dims
    is ``Shard(d)`` on each, which shards it major to minor in the
    mesh's order, as the reference's tuple entries do."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if d is None else Shard(d)
                 for d in shard_dims(spec, tuple(mesh.mesh_dim_names), ndim))


def _cuts(spec, axis_sizes: dict, ndim: int, coord=None) -> list:
    """How ``spec`` cuts each dim of a tensor of ``ndim`` dims over a
    mesh of ``axis_sizes`` (axis name -> size, in the mesh's order): per
    dim, (ways, index), the product of the sizes of the axes sharding it
    and the block that the mesh coordinate ``coord`` (all zeros where
    not given) holds over them, major to minor."""
    names = tuple(axis_sizes)
    coord = coord or (0,) * len(names)
    cuts = [(1, 0)] * ndim
    for i, d in enumerate(shard_dims(spec, names, ndim)):
        if d is not None:
            ways, index = cuts[d]
            n = axis_sizes[names[i]]
            cuts[d] = (ways * n, index * n + coord[i])
    return cuts


def local_shape(shape, spec, axis_sizes: dict) -> tuple:
    """The largest local shard's shape of a tensor of ``shape`` laid out
    by ``spec`` over a mesh of ``axis_sizes`` (axis name -> size, in the
    mesh's order): each dim divided, rounding up, by the product of the
    sizes of the axes it is sharded over."""
    return tuple(-(-n // w) for n, (w, _) in
                 zip(shape, _cuts(spec, axis_sizes, len(shape))))


def local_shard(t, spec, mesh):
    """This rank's shard of the whole tensor ``t`` laid out by ``spec`` on
    ``mesh`` (a ``DeviceMesh``): along each dim, the block of the rank's
    coordinate over the axes sharding it (major to minor in the mesh's
    order), of :func:`local_shape`'s size; ``t`` itself where no dim is
    cut.  A dim that its axes do not divide raises ``ValueError``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = t
    for dim, (w, i) in enumerate(_cuts(spec, sizes, t.ndim,
                                       mesh.get_coordinate())):
        if w > 1:
            if t.shape[dim] % w:
                raise ValueError(f"spec {spec}: dim {dim} of {t.shape[dim]} "
                                 f"does not split over {w} ranks")
            n = t.shape[dim] // w
            out = out.narrow(dim, i * n, n)
    return t if out is t else out.clone()


def local_tree(tree, specs, mesh):
    """A tree of tensors as a rank holds it: each leaf
    :func:`local_shard` by its spec in ``specs`` (the tree's structure
    with a spec at each leaf)."""
    return unflatten(tree, [local_shard(t, spec, mesh) for t, spec in zip(
        leaves(tree), flatten_up_to(tree, specs), strict=True)])


# ------------------------------------------------ collectives on a mesh
class Across(torch.autograd.Function):
    """A step that crosses ranks: ``fwd(t)`` forward and its adjoint
    ``bwd(grad)`` backward."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        out = fwd(t)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad.contiguous()), None, None


class _Solo:
    """A group of one process that no collective needs: the
    tensor-parallel group of a ``pure_dp`` place."""

    def __repr__(self):
        return "SOLO"


SOLO = _Solo()


def _ring(x, group):
    """The fixed-ring sum of ``x`` over ``group`` (``ordered_ring_reduce``;
    ``x`` itself over :data:`SOLO`)."""
    return x if group is SOLO else ordered_ring_reduce(x, group)


def gather(t, group, dim: int):
    """The group's tensors concatenated along ``dim`` in rank order
    (``t`` itself in a group of one)."""
    n = 1 if group is SOLO else dist.get_world_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def block(t, dim: int, index: int, ways: int):
    """Block ``index`` of ``ways`` equal blocks of ``t`` along ``dim``."""
    n = t.shape[dim] // ways
    return t.narrow(dim, index * n, n)


def _same(t):
    return t.view_as(t)


class Place:
    """One rank's place on ``prof``'s mesh for a call over an input of
    ``shape`` (B, S, ...).

    - ``model``, ``n_model``, ``m``: the tensor-parallel group, its size
      and the rank's coordinate: the model axis's, or under ``pure_dp``
      :data:`SOLO`, 1 and 0;
    - ``vocab``, ``n_vocab``, ``v``: the model axis's, which cuts the
      embedding and the head by vocab block under every profile;
    - ``data`` (with ``n_data``, ``i_data``, the flat size and
      coordinate): the groups of the axes FSDP cuts over, mesh order,
      major first: the data axes, and under ``pure_dp`` the model axis
      after them;
    - ``batch`` (``n_batch``, ``i_batch``): those of ``prof.da``, which
      cut the batch;
    - ``seq_split``: whether the sequence splits over the model axis (it
      divides it, ``seq_shard`` asks for it, and the profile is not
      ``pure_dp``).

    Refuses a mesh whose dims are not the profile's data axes and model
    axis."""

    def __init__(self, prof: Profile, shape, *, seq_shard: bool | None = None):
        mesh = prof.mesh
        names = tuple(mesh.mesh_dim_names or ())
        want = tuple(prof.data_axes) + (prof.model_axis,)
        if names != want:
            raise ValueError(f"a model on a mesh takes a mesh of dims "
                             f"{want}; got {names}")
        self.prof = prof
        coord = mesh.get_coordinate()
        axis = lambda a: (mesh.get_group(a), mesh.size(names.index(a)),
                          coord[names.index(a)])
        self.vocab, self.n_vocab, self.v = axis(prof.model_axis)
        self.model, self.n_model, self.m = (
            (SOLO, 1, 0) if prof.pure_dp else
            (self.vocab, self.n_vocab, self.v))
        self.data = [axis(a) for a in (want if prof.pure_dp else want[:-1])]
        self.n_data, self.i_data = self._flat(self.data)
        self.batch = [axis(a) for a in axis_names(prof.da)]
        self.n_batch, self.i_batch = self._flat(self.batch)
        b, s = shape[0], shape[1]
        if b % self.n_batch:
            raise ValueError(f"a batch of {b} does not split over the data "
                             f"axes {axis_names(prof.da)} of {self.n_batch} "
                             f"ranks")
        split = prof.seq_shard if seq_shard is None else seq_shard
        self.seq_split = bool(split and not prof.pure_dp
                              and s % self.n_model == 0
                              and s >= self.n_model)
        self.shape = (b, s)

    @staticmethod
    def _flat(axes) -> tuple[int, int]:
        n, i = 1, 0
        for _, size, c in axes:
            n, i = n * size, i * size + c
        return n, i

    def _reduce(self, g, model: bool):
        """The fixed-ring sum of ``g`` over the batch's groups and, with
        ``model``, the model group."""
        groups = [group for group, _, _ in self.batch]
        for group in ([self.model] if model else []) + groups:
            g = _ring(g, group)
        return g

    # the rank's block of a (B, S, ...) tensor and its inverse
    def batch_block(self, x):
        return block(x, 0, self.i_batch, self.n_batch)

    def take_block(self, x):
        x = self.batch_block(x)
        if self.seq_split:
            x = block(x, 1, self.m, self.n_model)
        return x.contiguous()

    def gather_blocks(self, x):
        if self.seq_split:
            x = gather(x, self.model, 1)
        for group, _, _ in reversed(self.batch):    # minor axes first
            x = gather(x, group, 0)
        return x

    # a computation that every rank runs whole and alike (a MoE layer
    # whose blocks are not the residual stream's): its input and output
    # whole on every rank, and so their cotangents
    def whole_in(self, h):
        return Across.apply(h, self.gather_blocks, self.take_block)

    def whole_out(self, y):
        return Across.apply(y, self.take_block, self.gather_blocks)

    # Megatron-SP: a sublayer's entry gathers the sequence, its exit sums
    # the ranks' partial outputs into the rank's sequence block
    def seq_gather(self, x):
        """The rank's sequence block gathered whole over the model axis
        (no adjoint: a step that carries no gradient)."""
        return gather(x, self.model, 1) if self.seq_split else x

    def _seq_sum(self, x):
        x = _ring(x, self.model)
        if self.seq_split:
            x = block(x, 1, self.m, self.n_model).contiguous()
        return x

    def enter(self, h):
        """h (B_b, S_b, D), the rank's block, as the column-parallel
        projections take it: the sequence gathered over the model axis
        (the adjoint sums the ranks' partial cotangents into the block)."""
        return Across.apply(h, self.seq_gather, self._seq_sum)

    def leave(self, y):
        """The row-parallel partial outputs (B_b, S, D) summed over the
        model axis into the rank's block."""
        return Across.apply(y, self._seq_sum, self.seq_gather)

    def model_sum(self, t):
        """The sum of the ranks' ``t`` over the model axis, the same on
        every rank (a statistic of a whole row that each rank holds a
        block of); its adjoint sums the cotangents likewise."""
        total = lambda x: _ring(x, self.model)
        return Across.apply(t, total, total)

    def gather_heads(self, t):
        """A column-parallel projection's blocks (..., F / n_model)
        gathered over the model axis, for ranks that use every column
        (grouped K/V heads that do not split over it)."""
        return Across.apply(
            t, lambda x: gather(x, self.model, -1),
            lambda g: block(_ring(g, self.model), -1, self.m,
                            self.n_model).contiguous())

    def gather_logits(self, t):
        """(B_b, S, V / n_model) vocab blocks -> the whole (B, S, V),
        the same on every rank (the loss is computed whole on each)."""
        def fwd(x):
            x = gather(x, self.model, -1)
            for group, _, _ in reversed(self.batch):
                x = gather(x, group, 0)
            return x

        def bwd(g):
            return block(self.batch_block(g), -1, self.m,
                         self.n_model).contiguous()
        return Across.apply(t, fwd, bwd)

    # parameters
    def shared(self, w, model: bool):
        """A leaf used as the rank holds it, on the rank's tokens: its
        gradient summed over the batch's groups and, with ``model``, the
        tensor-parallel group, so that every rank gets the gradient of
        what it holds."""
        return Across.apply(w, _same, lambda g: self._reduce(g, model))

    def zero(self, w, dim: int):
        """A tensor-parallel leaf as the rank uses it: its FSDP shard
        (``prof.fsdp``: dim ``dim`` cut over the axes of ``data``)
        gathered over them (ZeRO), the gradient summed over the batch's
        groups and cut back to the shard."""
        if not (self.prof.fsdp and self.data):
            return self.shared(w, model=False)
        return self._gathered(w, dim, self.data)

    def _gathered(self, w, dim: int, axes):
        """``w``'s blocks along ``dim`` over the groups of ``axes``
        (major first) gathered whole; the gradient summed over the
        batch's groups and cut back to the rank's block."""
        n, i = self._flat(axes)

        def fwd(x):
            for group, _, _ in reversed(axes):
                x = gather(x, group, dim)
            return x

        def bwd(g):
            return block(self._reduce(g, model=False), dim, i,
                         n).contiguous()
        return Across.apply(w, fwd, bwd)

    def vocab_block(self, w, dim: int):
        """The embedding (``dim`` 0) or the head (``dim`` 1), held by
        vocab block over the model axis, as the rank computes with it:
        its block (vocab ids from ``m`` times the block's size), the
        gradient summed over the batch's groups; under ``pure_dp``,
        whose ranks hold other tokens of the batch, the whole leaf
        gathered over the model axis (``m`` is 0), the gradient summed
        and cut back to the block."""
        if not self.prof.pure_dp:
            return self.shared(w, model=False)
        return self._gathered(w, dim, [(self.vocab, self.n_vocab, self.v)])


def _as_is(x, *args, **kwargs):
    return x


class Alone(Place):
    """The place of the one process of a profile without a mesh: every
    block is the whole and every step across ranks returns its input, no
    autograd step added, so the model's calls on it are the dense ones at
    no cost."""

    n_model = n_vocab = n_batch = n_data = 1
    m = v = i_batch = i_data = 0
    model = vocab = None
    data = batch = ()
    seq_split = False

    def __init__(self):
        pass

    batch_block = take_block = gather_blocks = whole_in = whole_out = \
        seq_gather = enter = leave = model_sum = gather_heads = \
        gather_logits = shared = zero = vocab_block = staticmethod(_as_is)


ALONE = Alone()


def place_of(prof: Profile, shape) -> Place:
    """The rank's :class:`Place` for a call over an input of ``shape``
    on ``prof``'s mesh, or :data:`ALONE` on a profile without one."""
    if prof.enabled and prof.mesh is not None:
        return Place(prof, shape)
    return ALONE
