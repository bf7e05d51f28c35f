"""Transactional object store (TStore) and its layout, after
``repro.core.tstore``.

Two layouts of one address space, described by :class:`StoreLayout`:

* :class:`TStore`, the dense layout (the one-shard case):

  * ``values``   (O, S) int32 — O objects, each a slot-vector of S words;
  * ``versions`` (O,)   int32 — per-object version = sequence number of
    the last committed writer (0 = initial state);
  * ``gv``       ()     int32 — global version = sequence number of the
    last committed transaction.

* :class:`ShardedStore`, the address space cut into S contiguous range
  shards of C = ceil(O/S) objects (object ``a`` lives in shard ``a // C``
  at offset ``a % C``): ``values`` (S, C, slot), ``versions`` (S, C) and
  ``gv``.  The last shard may carry padding rows past object O-1; they
  are never addressed, never written, and left out of the fingerprint.

The global serialization order lives in rank space, while footprints,
conflict analysis and write-back decompose per address, hence per
shard: a sharded store gives the dense store's fingerprints, traces and
replay logs under every engine.  Execution reads the stacked shards as
one (S·C, slot) image through :func:`flat_values`, a view of the stacked
tensor, so that a write into a shard is a write into that image.

**One shard per rank** (``mesh``, a 1-D ``DeviceMesh`` of exactly S
ranks, the reference's ``shard_map`` placement): the port is SPMD, one
process per shard, and rank s holds only shard s, a ``(1, C, slot)``
:class:`ShardedStore`.  Every rank runs the same host loop over
replicated, deterministic state (sequencer, footprints, conflict table,
prefix), so they decide alike.  A load of a row another rank owns goes
through :class:`MeshRows`, an exchange in which each rank answers only
its own addresses (an ``all_gather`` of the answers, then a select by
owner: bitwise, no reduction), and the images (:func:`dense_image`,
:func:`shard_images`, :func:`unshard_store`, :func:`fingerprint`)
gather the shards in rank order, the same value on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime.shardings import gather

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class StoreLayout:
    """How the object address space is laid out: ``shards`` contiguous
    ranges of ``shard_size`` objects; global address ``a`` maps to
    ``(a // shard_size, a % shard_size)``.  The dense store is the
    ``shards == 1`` case.  ``mesh``, a 1-D ``DeviceMesh`` of ``shards``
    ranks, places shard s on rank s alone (module docstring)."""

    n_objects: int
    shards: int = 1
    mesh: object = None

    @property
    def shard_size(self) -> int:
        """Objects per shard C = ceil(O/S); the last shard may pad."""
        return -(-self.n_objects // self.shards)

    @property
    def padded_objects(self) -> int:
        """S * C >= O — the flat length of the stacked shard images."""
        return self.shards * self.shard_size

    @property
    def sharded(self) -> bool:
        """True iff the store's tensors carry the stacked-shard axes.  A
        one-shard layout with a mesh counts: its tensors are (1, C, slot)
        and it takes the sharded paths (every :class:`ShardedStore` has
        ``shards > 1`` or a mesh)."""
        return self.shards > 1 or self.mesh is not None

    @property
    def rank(self) -> int | None:
        """The shard this process holds under a mesh, else None (it holds
        them all)."""
        return None if self.mesh is None else self.mesh.get_local_rank()

    @property
    def held_shards(self) -> int:
        """Leading extent of this process's stacked shards: 1 under a
        mesh, else ``shards``."""
        return 1 if self.mesh is not None else self.shards

    @property
    def words_per_shard(self) -> int:
        """Packed-bitset width per shard, ceil(C/32): the conflict
        kernels' W axis shrinks by S under the sharded layout."""
        return -(-self.shard_size // 32)

    def shard_of(self, addr: torch.Tensor) -> torch.Tensor:
        return addr // self.shard_size

    def offset_of(self, addr: torch.Tensor) -> torch.Tensor:
        return addr % self.shard_size


@dataclasses.dataclass
class TStore:
    values: torch.Tensor    # (O, S) int32
    versions: torch.Tensor  # (O,)   int32
    gv: torch.Tensor        # ()     int32

    @property
    def n_objects(self) -> int:
        return self.values.shape[0]

    @property
    def slot(self) -> int:
        return self.values.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def layout(self) -> StoreLayout:
        return StoreLayout(self.n_objects, 1)


# the reference's name for the dense layout
DenseStore = TStore


@dataclasses.dataclass
class ShardedStore:
    """Range-partitioned store: S stacked shard images (module doc), or
    under a ``mesh`` this rank's one shard.  ``n_objects`` is the real
    object count, which the padded shapes cannot give back."""

    values: torch.Tensor    # (S, C, slot) int32; (1, C, slot) on a mesh
    versions: torch.Tensor  # (S, C)       int32; (1, C)
    gv: torch.Tensor        # ()           int32
    n_objects: int
    mesh: object = None

    @property
    def shards(self) -> int:
        return self.values.shape[0] if self.mesh is None else self.mesh.size()

    @property
    def shard_size(self) -> int:
        return self.values.shape[1]

    @property
    def slot(self) -> int:
        return self.values.shape[2]

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def layout(self) -> StoreLayout:
        return StoreLayout(self.n_objects, self.shards, self.mesh)


class MeshRows:
    """The flat (S·C, slot) image of a store cut one shard per rank, as
    the executor reads it: ``rows[addr]`` for a (K,) address vector that
    every rank holds alike.  Each rank answers the addresses in its own
    range (zeros elsewhere), the answers are all-gathered in rank order,
    and each address takes its owner's answer: a select, so the rows are
    the stored bits."""

    def __init__(self, local: torch.Tensor, layout: StoreLayout):
        self.local, self.layout = local, layout     # (C, slot)
        self.shape = (layout.padded_objects, local.shape[1])
        self.device = local.device

    def __getitem__(self, addr: torch.Tensor) -> torch.Tensor:
        c = self.layout.shard_size
        owner, off = addr // c, addr % c
        mine = (owner == self.layout.rank)[:, None]
        answer = torch.where(mine, self.local[off], 0)
        parts = gather(answer[None], self.layout.mesh.get_group(), 0)
        return parts[owner, torch.arange(addr.shape[0],
                                         device=addr.device)]


def check_mesh(mesh, shards: int) -> None:
    """The reference's refusal of a mesh other than one axis of
    ``shards`` ranks."""
    sizes = tuple(getattr(mesh, "shape", ()) or ())
    if not hasattr(mesh, "get_group") or len(sizes) != 1 \
            or sizes[0] != shards:
        raise ValueError(
            f"mesh must have exactly one axis of size shards={shards}, "
            f"got {mesh!r}")


def flat_values(values: torch.Tensor,
                layout: StoreLayout | None) -> torch.Tensor:
    """The executor-facing flat (O_pad, slot) image: the dense image
    itself, or a view of the stacked (S, C, slot) shards (shard s's row c
    IS global object s·C + c, so no permutation is needed), or under a
    mesh the exchange of :class:`MeshRows`.  Rows past
    ``layout.n_objects`` are padding, never addressed (every effective
    address is reduced mod n_objects)."""
    if layout is None or not layout.sharded:
        return values
    if layout.mesh is not None:
        return MeshRows(values[0], layout)
    s, c, slot = values.shape
    return values.view(s * c, slot)


def store_with(store, values, versions, gv):
    """Rebuild a store of the same layout around new contents."""
    return dataclasses.replace(store, values=values, versions=versions,
                               gv=gv)


def make_store(n_objects: int, slot: int = 1, init=None, *,
               shards: int = 1, mesh=None, device="cuda"):
    """Create a fresh store on ``device``.  ``init`` is an optional (O, S)
    initial image; ``shards > 1`` returns a :class:`ShardedStore` over
    that many contiguous address ranges, and ``mesh`` this rank's one
    shard of them (:func:`shard_store`)."""
    if init is None:
        values = torch.zeros((n_objects, slot), dtype=_I32, device=device)
    else:
        values = torch.as_tensor(np.asarray(init, np.int32)).reshape(
            n_objects, -1).to(device)
    dense = TStore(
        values=values,
        versions=torch.zeros((n_objects,), dtype=_I32, device=device),
        gv=torch.zeros((), dtype=_I32, device=device))
    return shard_store(dense, shards, mesh=mesh)


def shard_store(store: TStore, shards: int, mesh=None):
    """Partition a dense store into ``shards`` contiguous range shards,
    padding the address space up to S·ceil(O/S) with inert rows.
    ``shards == 1`` without a mesh is the dense layout already: the store
    comes back unchanged.  With ``mesh`` (a 1-D ``DeviceMesh`` of
    ``shards`` ranks, else ``ValueError``) each rank keeps only its own
    shard, a copy; ``store`` is the whole dense store, alike on every
    rank."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards == 1 and mesh is None:
        return store
    if mesh is not None:
        check_mesh(mesh, shards)
    layout = StoreLayout(store.n_objects, shards, mesh)
    pad = layout.padded_objects - store.n_objects
    values = torch.nn.functional.pad(store.values, (0, 0, 0, pad)).reshape(
        shards, layout.shard_size, store.slot)
    versions = torch.nn.functional.pad(store.versions, (0, pad)).reshape(
        shards, layout.shard_size)
    if mesh is not None:
        r = layout.rank
        values, versions = values[r:r + 1].clone(), versions[r:r + 1].clone()
    return ShardedStore(values=values, versions=versions, gv=store.gv,
                        n_objects=store.n_objects, mesh=mesh)


def _stacked(store) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, C, slot) values and (S, C) versions of every shard, gathered
    in rank order under a mesh."""
    if store.mesh is None:
        return store.values, store.versions
    group = store.mesh.get_group()
    return (gather(store.values, group, 0), gather(store.versions, group, 0))


def unshard_store(store) -> TStore:
    """The dense store of a sharded one (padding dropped; the tensors are
    views of the shards, or under a mesh of their gather, the same on
    every rank).  A dense store comes back unchanged."""
    if isinstance(store, TStore):
        return store
    o = store.n_objects
    values, versions = _stacked(store)
    return TStore(values=values.reshape(-1, store.slot)[:o],
                  versions=versions.reshape(-1)[:o], gv=store.gv)


def shard_images(store) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-shard ``(values, versions)`` images, trimmed to real rows: the
    snapshot form (``repro_torch.core.checkpoint``), whose concatenation
    is the dense image, so a snapshot written at S shards restores into
    any S'.  A dense store yields its one image; a store cut over a mesh
    every shard's, gathered, on every rank."""
    if isinstance(store, TStore):
        return [(store.values, store.versions)]
    o, c = store.n_objects, store.shard_size
    values, versions = _stacked(store)
    out = []
    for s in range(store.shards):
        rows = min(o, (s + 1) * c) - min(o, s * c)
        out.append((values[s, :rows], versions[s, :rows]))
    return out


def dense_image(store) -> torch.Tensor:
    """The (O, slot) committed image of either layout (under a mesh the
    shards gathered in rank order, the same on every rank)."""
    if isinstance(store, ShardedStore):
        return _stacked(store)[0].reshape(-1, store.slot)[:store.n_objects]
    return store.values


_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_MASK32 = 0xFFFFFFFF


def fingerprint(store) -> int:
    """Order-sensitive 32-bit FNV-1a of the dense image (one step per
    int32 word, row-major), bitwise equal to the reference's.
    Layout-blind: a sharded store hashes its dense image, padding left
    out.

    Computed on the host in integer arithmetic masked to 32 bits: the
    hash is a sequential chain, and one device launch per word would
    cost far more than the host loop."""
    words = dense_image(store).reshape(-1).cpu().numpy().view(np.uint32)
    h = _FNV_OFFSET
    for x in words.tolist():
        h = ((h ^ x) * _FNV_PRIME) & _MASK32
    return h
