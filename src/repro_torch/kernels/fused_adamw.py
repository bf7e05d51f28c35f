"""Fused AdamW, the fast-mode direct commit of a gradient into the
parameter store: the wrappers around the hand-written Hopper kernels of
``csrc/fused_adamw.cu``.

The paper's fast transaction merges the read and write phases and
installs its update in place with no tracking.  The framework's
highest-volume transaction is a gradient commit, and its fast path is
one pass over (p, m, v, g) that produces (p', m', v'), with every
parameter word moved once.  The speculative variant is the same update
under TL2 version validation: each 256 x 256 block of a (R, C) leaf
carries a version, and a block whose version exceeds the transaction's
read version ``rv`` is stale: it is left as it was and reported in
``abort`` for a retry.

    p, m, v float32 (any shape; (R, C) with R % 256 = C % 256 = 0 for the
    speculative variant), g float32 or bfloat16 of the same shape,
    hp (1, 8) float32 = [lr, b1, b2, eps, wd, bc1, bc2, rv] (hp_vector),
    versions (R / 256, C / 256) int32

Both wrappers are functional, as the reference's kernels are: they
return fresh tensors and leave their inputs as they were.  Each takes
CPU tensors to its plain version in :mod:`repro_torch.kernels.ref` and
CUDA tensors to the kernel, or raises; there is no fallback from one to
the other.  ``LAUNCHES`` counts kernel launches (never plain-version
calls).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"fused_adamw": 0, "fused_adamw_speculative": 0}
BLOCK = 256   # rows and columns of a speculative version block
_ENTRY = {torch.float32: "pot_adamw_f32g", torch.bfloat16: "pot_adamw_bf16g"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def hp_vector(step, *, lr, b1, b2, eps, wd, rv=0.0, device) -> torch.Tensor:
    """The (1, 8) float32 hyperparameter vector of the reference's
    ``_hp_vector``, built on ``device``: ``bc1 = 1 - b1**step`` and
    ``bc2 = 1 - b2**step`` in float32 there.  ``step`` and ``rv`` may be
    numbers or tensors; a tensor already on ``device`` (the training
    step's counter) is read there, with no copy from the host."""
    def f32(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.float32)
        return torch.full((), x, dtype=torch.float32, device=device)

    step, b1, b2 = f32(step), f32(b1), f32(b2)
    return torch.stack([f32(lr), b1, b2, f32(eps), f32(wd),
                        1.0 - b1 ** step, 1.0 - b2 ** step,
                        f32(rv)]).reshape(1, 8)


def _check(p, m, v, g, hp) -> None:
    for name, t in (("p", p), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.shape != p.shape:
            raise ValueError(f"{name} must be float32 of shape "
                             f"{tuple(p.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if g.dtype not in _ENTRY or g.shape != p.shape:
        raise ValueError(f"g must be float32 or bfloat16 of shape "
                         f"{tuple(p.shape)}, got {g.dtype} {tuple(g.shape)}")
    if hp.shape != (1, 8) or hp.dtype != torch.float32:
        raise ValueError(f"hp must be (1, 8) float32, got {hp.dtype} "
                         f"{tuple(hp.shape)}")
    for t in (m, v, g, hp):
        if t.device != p.device:
            raise ValueError(f"tensors on {t.device} and {p.device}")


def _outputs(p):
    return [torch.empty(p.shape, dtype=torch.float32, device=p.device)
            for _ in range(3)]


def fused_adamw(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, hp: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step of a leaf: returns fresh ``(p', m', v')``."""
    _check(p, m, v, g, hp)
    if not _build.on_card(p, "fused_adamw"):
        return ref.adamw_ref(p, m, v, g, hp)
    po, mo, vo = _outputs(p)
    if p.numel() == 0:
        return po, mo, vo
    args = [t.contiguous() for t in (hp, p, m, v, g)]
    _build.launch("fused_adamw", _ENTRY[g.dtype], p.device,
                  *(t.data_ptr() for t in args + [po, mo, vo]), p.numel())
    LAUNCHES["fused_adamw"] += 1
    return po, mo, vo


def fused_adamw_speculative(p: torch.Tensor, m: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor,
                            versions: torch.Tensor, hp: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """The validated step of a (R, C) leaf: returns fresh
    ``(p', m', v', abort)``, where a block whose version (compared as
    float32, as the reference's kernel compares it) exceeds ``hp[0, 7]``
    keeps p, m and v and has ``abort = 1``."""
    _check(p, m, v, g, hp)
    if p.dim() != 2 or p.numel() == 0 or p.shape[0] % BLOCK \
            or p.shape[1] % BLOCK:
        raise ValueError(f"p must be (R, C) with R and C positive multiples "
                         f"of {BLOCK}, got {tuple(p.shape)}")
    grid = (p.shape[0] // BLOCK, p.shape[1] // BLOCK)
    if versions.shape != grid or versions.dtype != torch.int32 \
            or versions.device != p.device:
        raise ValueError(f"versions must be {grid} int32 on {p.device}, got "
                         f"{versions.dtype} {tuple(versions.shape)} on "
                         f"{versions.device}")
    if not _build.on_card(p, "fused_adamw_speculative"):
        return ref.adamw_speculative_ref(p, m, v, g, versions, hp)
    po, mo, vo = _outputs(p)
    abort = torch.empty(grid, dtype=torch.int32, device=p.device)
    # the kernel reads float32 g; the conversion from bfloat16 is exact
    args = [t.contiguous() for t in (hp, versions, p, m, v, g.float())]
    _build.launch("fused_adamw", "pot_adamw_spec", p.device,
                  *(t.data_ptr() for t in args + [po, mo, vo, abort]),
                  *p.shape)
    LAUNCHES["fused_adamw_speculative"] += 1
    return po, mo, vo, abort
