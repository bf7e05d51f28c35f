"""Model FLOPs of a training step, counted from the configuration's
sizes alone (the port's ``"port"`` entry of a configuration file).

A FLOP is counted as in the PaLM paper's model FLOPs utilization: 6 per
active matmul parameter per token (forward 2, backward 4), plus
12 x layers x (heads x head size) x sequence per token for the
attention's score and value products.  Recomputation (remat), capacity
padding and embedding gathers are not counted: they are the program's
choices, not the model's work.
"""

from __future__ import annotations


def head_dim(port: dict) -> int:
    return port.get("head_dim") or port["d_model"] // port["n_heads"]


def _layer_kinds(port: dict) -> list[str]:
    pattern = list(port.get("pattern", ["attn"]))
    n = port["n_layers"]
    return (pattern * (n // len(pattern))) + pattern[: n % len(pattern)]


def active_matmul_params(port: dict) -> int:
    """Matmul parameters a token passes through: every layer's
    attention projections and MLP (of a MoE layer, the router, the
    ``top_k`` experts it is routed to and the shared experts), and the
    output head.  The embedding is a gather, not a matmul."""
    d, hd = port["d_model"], head_dim(port)
    h, kv = port["n_heads"], port["n_kv_heads"]
    n = 0
    for kind in _layer_kinds(port):
        if kind != "attn":
            raise ValueError(f"no FLOP count for layer kind {kind!r}")
        n += d * h * hd + 2 * d * kv * hd + h * hd * d
        width = 3 if port.get("mlp", "swiglu") == "swiglu" else 2
        if port.get("n_experts"):
            n += d * port["n_experts"]
            n += port["top_k"] * width * d * port["d_ff"]
            n += port.get("n_shared_experts", 0) * width * d * port["d_ff"]
        else:
            n += width * d * port["d_ff"]
    return n + d * port["vocab"]


def model_flops_per_token(port: dict, seq: int) -> float:
    """6 x active matmul parameters + 12 x layers x (heads x head size)
    x ``seq``."""
    attn = 12 * port["n_layers"] * port["n_heads"] * head_dim(port) * seq
    return 6.0 * active_matmul_params(port) + attn
