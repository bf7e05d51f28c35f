"""The plain reference of the port's training step: float32 PyTorch,
TF32 off, written from the equations the port documents and importing
nothing of it.

A training step of the reference (:func:`run_steps`) takes the same
initial weights and token batches as the program, cuts each batch into
the program's microbatches (contiguous rows, in order), adds each
microbatch's gradient of its mean next-token loss, divided by their
number, into the leaves' ``.grad`` in sequence order, and applies
AdamW with decoupled weight decay in float32:

    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2
    p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

The model (``forward_loss``), as the port documents it: token
embedding; per layer a pre-norm residual block of RMSNorm, attention
and RMSNorm, feed-forward; a final RMSNorm and an untied head.

- RMSNorm: x / sqrt(mean(x^2) + eps) * w.
- Attention: q, k, v = x Wq, x Wk, x Wv; RoPE on q and k at positions
  0..S-1 over the head's two halves (x1, x2) -> (x1 cos - x2 sin,
  x2 cos + x1 sin), angle p / theta^(i / (hd/2)); grouped K/V heads,
  query head j reading K/V head j // (H / KV); scores q k^T / sqrt(hd),
  causal, softmax; the heads' outputs through Wo.
- SwiGLU: (silu(x W1) * x W3) W2.

Every product goes through a :class:`Precision`: float32 for the
reference, its operands rounded to a lower precision for the controls
that decide whether the comparison can tell a lower precision apart.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ----------------------------------------------------------------- trees
def flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) of a tree of dicts and lists, in container order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in flatten(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def rebuild(tree, values):
    """A tree of ``tree``'s structure holding ``values`` in order."""
    it = iter(values)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return next(it)
    return walk(tree)


# ------------------------------------------------------------- precision
class Precision:
    """The precision of the products, each taken in float32 from operands
    rounded as ``kind`` says: ``"float32"`` (the reference) rounds
    nothing; ``"float8_e4m3fn"`` rounds both operands of every product
    to e4m3 (scaled per tensor so that its largest magnitude is e4m3's
    largest, 448, as fp8 training scales); ``"bfloat16_scores"`` rounds
    to bf16 the operands of attention's two products alone (the scores
    q k^T and the probabilities' sum of values), the configuration's
    float32 scores taken one step down.  The gradient passes the
    rounding unchanged."""

    KINDS = {"float32": ("float32", "float32"),
             "float8_e4m3fn": ("float8_e4m3fn", "float8_e4m3fn"),
             "bfloat16_scores": ("float32", "bfloat16")}

    def __init__(self, kind: str = "float32"):
        if kind not in self.KINDS:
            raise ValueError(f"precision {kind!r} is not one of "
                             f"{tuple(self.KINDS)}")
        self.kind = kind
        self.products, self.scores = self.KINDS[kind]

    @staticmethod
    def round(t: torch.Tensor, to: str) -> torch.Tensor:
        if to == "float32":
            return t
        d = t.detach()
        if to == "bfloat16":
            r = d.to(torch.bfloat16).float()
        else:
            s = d.abs().amax().clamp(min=1e-30) / 448.0
            r = (d / s).to(torch.float8_e4m3fn).float() * s
        return t + (r - d)

    def mm(self, a, b):
        return self.round(a, self.products) @ self.round(b, self.products)

    def attend(self, eq: str, a, b):
        """One of attention's two products."""
        return torch.einsum(eq, self.round(a, self.scores),
                            self.round(b, self.scores))


@contextlib.contextmanager
def float32_products():
    """TF32 off for matmuls and convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


# ----------------------------------------------------------------- model
def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def rope(x, theta: float):
    """x (B, S, H, hd) at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.tensor([1.0 / theta ** (i / half) for i in range(half)],
                         dtype=torch.float32, device=x.device)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * freqs[None]
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x, cfg: dict, prec: Precision):
    """Causal grouped-query attention with RoPE over x (B, S, D)."""
    b, s, _ = x.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    q = rope(prec.mm(x, p["wq"]).view(b, s, h, hd), cfg["rope_theta"])
    k = rope(prec.mm(x, p["wk"]).view(b, s, kv, hd), cfg["rope_theta"])
    v = prec.mm(x, p["wv"]).view(b, s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = prec.attend("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = prec.attend("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * hd)
    return prec.mm(out, p["wo"])


def swiglu(p: dict, x, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, p["w1"])) * prec.mm(x, p["w3"]),
                   p["w2"])


def forward_loss(params: dict, tokens, labels, cfg: dict, prec: Precision,
                 ffn, remat: bool = False):
    """Mean next-token cross-entropy of ``tokens`` (B, S) against
    ``labels``; ``ffn(layer_params, h)`` is the layer's feed-forward
    sublayer; ``remat`` recomputes each layer in the backward pass (the
    same numbers, less memory)."""
    eps = cfg["norm_eps"]

    def layer(lp, x):
        x = x + attention(lp["attn"], rmsnorm(x, lp["ln1"], eps), cfg, prec)
        return x + ffn(lp, rmsnorm(x, lp["ln2"], eps))

    x = params["embed"][tokens]
    for lp in params["layers"]:
        x = checkpoint(layer, lp, x, use_reentrant=False) if remat \
            else layer(lp, x)
    head = params["head"] if "head" in params else params["embed"].T
    logits = prec.mm(rmsnorm(x, params["final_norm"], eps), head)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean()


# ------------------------------------------------------------- training
def run_steps(family, params: dict, batch_at, cfg: dict, traffic: dict,
              prec: Precision, n_steps: int):
    """``n_steps`` reference training steps from ``params`` (their leaves
    are trained in place).  ``family.accumulate(params, tokens, labels,
    cfg, prec, weight)`` adds ``weight`` x the gradient of a microbatch's
    mean loss into the leaves' ``.grad`` and returns that mean loss.
    Returns (each step's loss, the first step's gradient norm of each
    leaf)."""
    hp = traffic["adamw"]
    lr, b1, b2, eps, wd = (hp[k] for k in ("lr", "b1", "b2", "eps", "wd"))
    n_mb = traffic["microbatches"]
    leaves = [t for _, t in flatten(params)]
    for t in leaves:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses, grad_norms = [], None
    with float32_products():
        for i in range(n_steps):
            batch = batch_at(i)
            rows = batch["tokens"].shape[0] // n_mb
            loss = 0.0
            for j in range(n_mb):
                cut = slice(j * rows, (j + 1) * rows)
                loss += float(family.accumulate(
                    params, batch["tokens"][cut], batch["labels"][cut], cfg,
                    prec, 1.0 / n_mb)) / n_mb
            losses.append(loss)
            if grad_norms is None:
                grad_norms = [0.0 if t.grad is None else float(t.grad.norm())
                              for t in leaves]
            with torch.no_grad():
                bc1, bc2 = 1.0 - b1 ** (i + 1), 1.0 - b2 ** (i + 1)
                for p, mi, vi in zip(leaves, m, v):
                    g = torch.zeros_like(p) if p.grad is None else p.grad
                    mi.mul_(b1).add_(g, alpha=1.0 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    upd = (mi / bc1) / ((vi / bc2).sqrt_() + eps)
                    p.sub_(lr * (upd + wd * p))
                    p.grad = None
    for t in leaves:
        t.requires_grad_(False)
    return losses, grad_norms
