"""Static model configuration shared by all 10 assigned architectures."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # layer pattern: tuple of kinds, repeated to n_layers.
    # kinds: "attn" (global), "local" (sliding window), "mamba", "rglru"
    pattern: tuple = ("attn",)
    window: int = 0             # sliding window for "local" layers
    qkv_bias: bool = False
    mlp: str = "swiglu"         # swiglu | gelu | none
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    residual_d_ff: int = 0         # width of the dense-residual FFN
    capacity_factor: float = 1.25
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # RG-LRU (recurrentgemma)
    rnn_width: int = 0           # 0 -> d_model
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    n_frames: int = 1500         # stub audio frontend output length
    # VLM
    n_patches: int = 0           # stub vision frontend output length
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables round the vocab up to a multiple of 256
        (Megatron-style) so the vocab dim always shards evenly; labels
        never reference the padding."""
        return -(-self.vocab // 256) * 256

    @property
    def group_size(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> tuple:
        """Remainder layers when n_layers % len(pattern) != 0 (e.g.
        gemma3's 62 = 10×(5 local + 1 global) + 2 local)."""
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def d_inner(self) -> int:    # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytical parameter count (for 6·N·D roofline)."""
        d, hd = self.d_model, self.hd
        n = 0
        n += self.vocab * d                                # embed
        if not self.tie_embeddings:
            n += self.vocab * d                            # lm head
        per_layer = {}
        for kind in set(self.pattern):
            p = 0
            if kind in ("attn", "local"):
                p += d * self.n_heads * hd                 # wq
                p += 2 * d * self.n_kv_heads * hd          # wk, wv
                p += self.n_heads * hd * d                 # wo
                if self.qkv_bias:
                    p += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif kind == "mamba":
                di = self.d_inner
                p += d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                p += di * d                                # out proj
                p += self.conv_width * (di + 2 * self.ssm_state)
                p += 2 * self.ssm_heads                    # A_log, D
            elif kind == "rglru":
                w = self.rnn_width or d
                p += 2 * d * w + w * d                     # in(x2), out
                p += 2 * w                                 # gates a, input
            p += 2 * d                                     # norms
            if kind != "mamba":
                if self.n_experts:
                    p += self.n_experts * 3 * d * self.d_ff
                    p += d * self.n_experts                # router
                    if self.n_shared_experts:
                        p += self.n_shared_experts * 3 * d * self.d_ff
                    if self.dense_residual:
                        p += 3 * d * self.residual_d_ff
                elif self.mlp == "swiglu":
                    p += 3 * d * self.d_ff
                elif self.mlp == "gelu":
                    p += 2 * d * self.d_ff
            per_layer[kind] = p
        for kind in self.pattern:
            n += per_layer[kind] * self.n_groups
        for kind in self.tail_pattern:
            n += per_layer[kind]
        if self.encoder_layers:
            enc = (2 * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd)
                   + 2 * self.d_ff * d + 4 * d)
            n += self.encoder_layers * enc
            # decoder cross-attention (already counted pattern as self-attn)
            n += self.n_layers * (d * self.n_heads * hd
                                  + 2 * d * self.n_kv_heads * hd
                                  + self.n_heads * hd * d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model \
            * self.d_ff * self.n_layers
        return full - inactive
