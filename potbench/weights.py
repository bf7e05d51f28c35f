"""The initial float32 weights, made on the device from the seed, in the
port's parameter tree (its layout read from the program's ``meta``
build: shapes and names, no values).

Standard normals are drawn in chunks of ``CHUNK`` elements, one
generator call a chunk, and laid end to end over the leaves in tree
order; a leaf of two or more dims takes them times its fan-in^-1/2
(its second-to-last dim), ``embed`` and ``head`` times 0.02, and a
vector (a norm's scale) is ones.  The same seed gives the same weights,
so the reference and the change of the weights after the checked steps
read them again from the seed instead of keeping a copy."""

from __future__ import annotations

import dataclasses

import torch

from potbench.reference.common import flatten, rebuild
from potbench.seeds import sub_seed

CHUNK = 1 << 28


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: str
    shape: tuple
    offset: int     # of its first element in the stream of normals
    std: float      # 0: ones

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _std(path: str, shape: tuple) -> float:
    if len(shape) < 2:
        return 0.0
    if path.split(".")[-1] in ("embed", "head"):
        return 0.02
    return shape[-2] ** -0.5


class Weights:
    def __init__(self, template, seed: int, device):
        """``template``: the program's parameter tree on ``meta``."""
        self.template, self.seed = template, seed
        self.device = torch.device(device)
        self.leaves, off = [], 0
        for path, t in flatten(template):
            leaf = Leaf(path, tuple(t.shape), off, _std(path, tuple(t.shape)))
            self.leaves.append(leaf)
            off += leaf.numel
        self.total = off

    def _chunks(self):
        """(first element, normals) of each chunk, in order."""
        for c, start in enumerate(range(0, self.total, CHUNK)):
            g = torch.Generator(device=self.device)
            g.manual_seed(sub_seed(self.seed, "weights", c))
            n = min(CHUNK, self.total - start)
            yield start, torch.randn(n, generator=g, device=self.device,
                                     dtype=torch.float32)

    def _overlaps(self, start: int, n: int):
        """(leaf index, its slice, the chunk's slice) of every random leaf
        that overlaps elements [start, start + n)."""
        for i, leaf in enumerate(self.leaves):
            if leaf.std == 0.0:
                continue
            a = max(start, leaf.offset)
            b = min(start + n, leaf.offset + leaf.numel)
            if a < b:
                yield (i, slice(a - leaf.offset, b - leaf.offset),
                       slice(a - start, b - start))

    def build(self):
        """A fresh parameter tree of float32 tensors on the device."""
        out = [torch.ones(leaf.shape, device=self.device) if leaf.std == 0.0
               else torch.empty(leaf.shape, device=self.device)
               for leaf in self.leaves]
        for start, z in self._chunks():
            for i, mine, theirs in self._overlaps(start, z.numel()):
                out[i].view(-1)[mine] = z[theirs] * self.leaves[i].std
        return rebuild(self.template, out)

    def change_norms(self, params) -> list[float]:
        """The norm of each leaf's change from the initial weights."""
        now = [t for _, t in flatten(params)]
        sq = [float(((t - 1.0) ** 2).sum()) if leaf.std == 0.0 else 0.0
              for t, leaf in zip(now, self.leaves)]
        for start, z in self._chunks():
            for i, mine, theirs in self._overlaps(start, z.numel()):
                d = now[i].detach().reshape(-1)[mine] \
                    - z[theirs] * self.leaves[i].std
                sq[i] += float((d * d).sum())
        return [s ** 0.5 for s in sq]
