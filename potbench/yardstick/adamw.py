"""Bytes one AdamW update of a parameter element needs, whatever
implements it: p, m, v (float32) and the gradient read once, p, m, v
written once."""

from __future__ import annotations


def bytes_per_element(grad_bytes: int) -> int:
    """28 B with a float32 gradient, 26 B with a bf16 one."""
    if grad_bytes not in (2, 4):
        raise ValueError(f"a gradient of {grad_bytes} B an element")
    return 3 * 4 + 3 * 4 + grad_bytes


def param_elements(port: dict) -> int:
    """Parameter elements of the port's tree for a dense or MoE attention
    model (``embed`` and ``head`` at the vocabulary rounded up to 256, as
    the port stores them; norms; every expert), from the sizes alone."""
    d, f = port["d_model"], port["d_ff"]
    h, kv = port["n_heads"], port["n_kv_heads"]
    hd = port.get("head_dim") or d // h
    vocab = -(-port["vocab"] // 256) * 256
    width = 3 if port.get("mlp", "swiglu") == "swiglu" else 2
    layer = 2 * d + d * h * hd + 2 * d * kv * hd + h * hd * d
    if port.get("n_experts"):
        e = port["n_experts"]
        layer += d * e + e * width * d * f
        layer += width * d * port.get("n_shared_experts", 0) * f
    else:
        layer += width * d * f
    tied = port.get("tie_embeddings", False)
    return port["n_layers"] * layer + (1 if tied else 2) * vocab * d + d
