"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Builds the selected architecture (full or smoke configuration) with
float32 master weights from a seeded generator on ``--device`` (the
card by default), the deterministic data pipeline and the Pot train
step, and runs with periodic atomic checkpoints and deterministic
resume.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--mode", choices=["pot", "baseline"], default="pot")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "pot_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # bitwise-reproducible steps on the card: cuBLAS needs a fixed
    # workspace before CUDA starts, and autograd's deterministic kernels
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    torch.use_deterministic_algorithms(True)

    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.train import init_state, make_train_step

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    if not args.smoke and cfg.param_count() > 2e9:
        print(f"WARNING: {cfg.name} has {cfg.param_count()/1e9:.1f}B "
              "params — its float32 weights and AdamW moments outgrow one "
              "card; use --smoke.", file=sys.stderr)

    print(f"arch={cfg.name} params={cfg.param_count():,} mode={args.mode}")
    params = lm.init_params(
        torch.Generator(device=args.device).manual_seed(0), cfg,
        dtype=torch.float32)
    state = init_state(params)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    step_fn = make_train_step(cfg, mode=args.mode,
                              n_microbatches=args.microbatches, remat=False,
                              lr=args.lr)

    start = 0
    if args.resume and (last := ck.latest_step(args.ckpt_dir)) is not None:
        state, extra = ck.restore(args.ckpt_dir, last, state)
        start = extra["data_step"]
        print(f"resumed at step {start} (gv={int(state.gv)})")

    for i in range(start, args.steps):
        batch = batch_at(dcfg, i, device=args.device)
        if cfg.encoder_layers:   # whisper's stub audio frontend
            frames = np.random.default_rng([7, i]).standard_normal(
                (args.batch, cfg.n_frames, cfg.d_model), np.float32)
            batch["frames"] = torch.from_numpy(frames).to(args.device)
        if cfg.n_patches:   # internvl2's stub vision frontend
            patches = np.random.default_rng([8, i]).standard_normal(
                (args.batch, cfg.n_patches, cfg.d_model), np.float32)
            batch["patches"] = torch.from_numpy(patches).to(args.device)
        state, loss = step_fn(state, batch)
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i+1:4d}  loss {float(loss):.4f}  "
                  f"gv {int(state.gv)}", flush=True)
        if (i + 1) % args.ckpt_every == 0:
            ck.save(args.ckpt_dir, i + 1, state,
                    extra={"data_step": i + 1})
            ck.prune(args.ckpt_dir)
    print("done")


if __name__ == "__main__":
    main()
