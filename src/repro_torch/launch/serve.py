"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Batched deterministic decoding with preordered slot commits
(``serve/session.py``) of the architecture's smoke configuration (any
of the ten: global or sliding-window attention, Mamba2, RG-LRU, MoE,
whisper's encoder-decoder), with weights drawn from a seeded generator
on ``--device`` (the card by default).  --replica-check runs two replicas with different request
interleavings and verifies bitwise-identical output — the paper's
fault-tolerance-by-replication property, live.
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--replica-check", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.session import Session

    cfg = get_smoke_config(args.arch)
    params = lm.init_params(
        torch.Generator(device=args.device).manual_seed(0), cfg)
    requests = [(s, 3 + 7 * s) for s in range(args.slots)]

    def run(order):
        sess = Session(cfg, params, n_slots=args.slots,
                       max_seq=args.max_seq, device=args.device)
        for slot, tok in order:
            sess.add_request(slot, tok)
        return sess.generate(args.steps), sess.fingerprint()

    toks, fp = run(requests)
    print(f"arch={cfg.name} slots={args.slots} device={args.device} "
          f"fingerprint=0x{fp:08x}")
    for s in range(args.slots):
        print(f"  slot {s}: {toks[s].tolist()}")
    if args.replica_check:
        toks2, fp2 = run(requests[::-1])
        same = np.array_equal(toks, toks2) and fp == fp2
        print(f"replica (reversed arrivals) identical: {same}")
        if not same:
            raise SystemExit("replicas diverged")


if __name__ == "__main__":
    main()
