"""Deterministic data-parallel training of a small LM, the port's
counterpart of ``examples/train_lm.py``:

    python -m repro_torch.launch.train_lm --steps 300                # one card
    python -m repro_torch.launch.train_lm --world 2 --device cpu --steps 20

The full Pot configuration over ``--world`` ranks:

- every microbatch gradient is a preordered transaction (ordered
  commits);
- gradients cross ranks by the fixed-ring ordered reduction
  (``optim/ordered_reduce.py``, through ``train.make_pot_dp_step``), so
  the weights are bitwise reproducible whatever the arrival timing;
- checkpoints carry (params, opt, gv, data_step), written by rank 0; a
  restart resumes the same serialization order;
- the run checks determinism live: it re-executes step 1 at the end and
  fails unless the recomputed parameters are bitwise identical.

On the card (the default) each rank is a process on its own card, joined
over NCCL; a world larger than the cards present raises.  With
``--device cpu`` the ranks are processes joined over gloo.  ``--world 1``
runs in this process with no process group: a ring of one rank is the
identity.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import tempfile
import time


def build_config(scale: str, layers: int = 0):
    """The reference example's 25m or 100m model, its depth cut to
    ``layers`` where that is given."""
    from repro_torch.models.config import ModelConfig
    if scale == "100m":
        cfg = ModelConfig(
            name="pot-lm-100m", family="dense", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000,
            pattern=("attn",), mlp="swiglu")
    else:  # ~25m, quick CPU runs
        cfg = ModelConfig(
            name="pot-lm-25m", family="dense", n_layers=8, d_model=512,
            n_heads=8, n_kv_heads=4, d_ff=1408, vocab=16384,
            pattern=("attn",), mlp="swiglu")
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(rank: int, args, init_method: str) -> None:
    """One rank: join the group (world > 1), train, leave."""
    import torch
    import torch.distributed as dist
    torch.use_deterministic_algorithms(True)
    cuda = args.device != "cpu"
    device = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(device)
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    if args.world > 1:
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=init_method,
                                world_size=args.world, rank=rank)
    try:
        train(rank, args, device)
    finally:
        if args.world > 1:
            dist.destroy_process_group()


def train(rank: int, args, device) -> None:
    import torch

    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.train import init_state, make_pot_dp_step
    from repro_torch.tree import leaves

    say = (lambda *a: print(*a, flush=True)) if rank == 0 else \
        (lambda *a: None)
    cfg = build_config(args.scale, args.layers)
    say(f"model={cfg.name} layers={cfg.n_layers} "
        f"params={cfg.param_count() / 1e6:.1f}M world={args.world} "
        f"device={args.device}")

    def fresh():
        return init_state(lm.init_params(
            torch.Generator(device=device).manual_seed(0), cfg,
            dtype=torch.float32))

    state = fresh()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    n_mb = max(1, min(args.microbatches, args.batch // args.world))
    step_fn = make_pot_dp_step(cfg, n_microbatches=n_mb, lr=3e-4)

    start = 0
    if args.resume and (last := ck.latest_step(args.ckpt_dir)) is not None:
        state, extra = ck.restore(args.ckpt_dir, last, state)
        start = extra["data_step"]
        say(f"resumed from step {start} (gv={int(state.gv)})")

    after_1 = None
    t0 = time.time()
    for i in range(start, args.steps):
        state, loss = step_fn(state, batch_at(dcfg, i, device=device))
        if i == 0:
            after_1 = [t.clone() for t in leaves(state.params)]
        if (i + 1) % 10 == 0 or i == start:
            dt = time.time() - t0
            say(f"step {i + 1:4d}  loss {float(loss):.4f}  gv "
                f"{int(state.gv)}  ({dt / (i - start + 1):.2f}s/step)")
        if (i + 1) % args.ckpt_every == 0 and rank == 0:
            ck.save(args.ckpt_dir, i + 1, state,
                    extra={"data_step": i + 1})
            ck.prune(args.ckpt_dir, keep=2)

    # ---- live determinism audit: replay step 1 from scratch ----
    if after_1 is not None:
        replay, _ = step_fn(fresh(), batch_at(dcfg, 0, device=device))
        bits = lambda t: t.view(torch.int32)
        same = all(torch.equal(bits(a), bits(b)) for a, b in
                   zip(after_1, leaves(replay.params), strict=True))
        say(f"replayed step 1 bitwise-identical: {same}")
        if not same:
            raise RuntimeError(f"rank {rank}: step 1 replayed differently")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", choices=["25m", "100m"], default="25m")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "pot_lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()

    # bitwise-reproducible steps on the card: cuBLAS needs a fixed
    # workspace before CUDA starts (the ranks inherit it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if args.device == "cuda" and args.world > torch.cuda.device_count():
        raise SystemExit(f"--world {args.world} needs {args.world} cards; "
                         f"{torch.cuda.device_count()} present")
    init = f"tcp://localhost:{_free_port()}"
    if args.world == 1:
        run(0, args, init)
    else:
        import torch.multiprocessing as mp
        mp.start_processes(run, args=(args, init), nprocs=args.world,
                           start_method="spawn", join=True)


if __name__ == "__main__":
    main()
