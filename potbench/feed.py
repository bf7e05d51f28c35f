"""The token batches of a traffic mix: step ``i``'s batch is
``global_batch`` rows of ``seq_len + 1`` tokens drawn uniformly over the
configuration's vocabulary on the device, from the seed and ``i``; the
tokens are the first ``seq_len``, the labels the last ``seq_len`` (the
next token).  Every step's rows differ."""

from __future__ import annotations

import torch

from potbench.seeds import sub_seed


class Feed:
    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        if traffic.get("tokens", "uniform") != "uniform":
            raise ValueError(f"no generator of {traffic['tokens']!r} tokens")
        self.rows, self.seq = traffic["global_batch"], traffic["seq_len"]
        self.vocab, self.seed = vocab, seed
        self.device = torch.device(device)

    def __call__(self, i: int) -> dict:
        g = torch.Generator(device=self.device)
        g.manual_seed(sub_seed(self.seed, "batch", i))
        x = torch.randint(0, self.vocab, (self.rows, self.seq + 1),
                          generator=g, device=self.device)
        return {"tokens": x[:, :-1].contiguous(),
                "labels": x[:, 1:].contiguous()}

    @property
    def tokens_per_step(self) -> int:
        return self.rows * self.seq
