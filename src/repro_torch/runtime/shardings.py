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
placements of a ``DeviceMesh``.  The port's model functions take no
profile: on one card every constraint is the identity.
"""

from __future__ import annotations

import dataclasses


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


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_dims(spec, names, ndim: int) -> list:
    """For each mesh dim (of axis names ``names``), the tensor dim that
    ``spec`` shards over it, or None.  A tuple entry takes its axes in
    the mesh's order, the first the most major."""
    owner = [None] * len(names)
    for dim, entry in enumerate(norm_spec(spec, ndim)):
        axes = _axes(entry)
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


def local_shape(shape, spec, axis_sizes: dict) -> tuple:
    """The largest local shard's shape of a tensor of ``shape`` laid out
    by ``spec`` over a mesh of ``axis_sizes`` (axis name -> size, in the
    mesh's order): each dim divided, rounding up, by the product of the
    sizes of the axes it is sharded over."""
    names = tuple(axis_sizes)
    ways = [1] * len(shape)
    for i, d in enumerate(shard_dims(spec, names, len(shape))):
        if d is not None:
            ways[d] *= axis_sizes[names[i]]
    return tuple(-(-n // w) for n, w in zip(shape, ways))
