"""The plain reference of a dense decoder (stablelm-12b's family): the
model of ``common.py`` with a SwiGLU feed-forward sublayer.  Rows are
independent, so a microbatch is taken in blocks of rows of at most
``BLOCK_TOKENS`` tokens, whose gradients add up to the microbatch's."""

from __future__ import annotations

from potbench.reference.common import Precision, forward_loss, swiglu

BLOCK_TOKENS = 4096


def ffn(lp: dict, h, prec: Precision):
    return swiglu(lp["mlp"], h, prec)


def accumulate(params, tokens, labels, cfg: dict, prec: Precision,
               weight: float):
    b, s = tokens.shape
    rows = max(1, BLOCK_TOKENS // s)
    total = 0.0
    for r in range(0, b, rows):
        cut = slice(r, min(b, r + rows))
        share = (cut.stop - cut.start) / b
        loss = forward_loss(params, tokens[cut], labels[cut], cfg, prec,
                            lambda lp, h: ffn(lp, h, prec))
        (loss * (weight * share)).backward()
        total += loss.detach() * share
    return total
