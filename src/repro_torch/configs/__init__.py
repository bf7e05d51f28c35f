"""Assigned architecture configs (--arch <id>) + input shapes.

Each module exports CONFIG (the exact assigned configuration) and
SMOKE_CONFIG (a reduced same-family config for CPU smoke tests).
"""

from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "mamba2_370m", "stablelm_12b", "gemma3_27b", "qwen15_32b",
    "starcoder2_15b", "arctic_480b", "deepseek_moe_16b", "whisper_medium",
    "recurrentgemma_9b", "internvl2_26b",
]

# canonical ids (hyphenated) -> module names
IDS = {a.replace("_", "-"): a for a in ARCHS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    mode: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs
LONG_OK = {"mamba2_370m", "recurrentgemma_9b"}


def get_config(arch: str):
    mod = IDS.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def get_smoke_config(arch: str):
    mod = IDS.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{mod}").SMOKE_CONFIG


def cells():
    """All 40 (arch, shape) cells; (runnable, skip_reason) flags."""
    out = []
    for arch in ARCHS:
        for sname, sh in SHAPES.items():
            skip = None
            if sname == "long_500k" and arch not in LONG_OK:
                skip = "full-attention arch: 500k exceeds design envelope"
            out.append((arch, sname, skip))
    return out
