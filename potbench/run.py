"""Run one cell of the benchmark of the port's Pot training step once.

    python potbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells).  The
last line of standard output is the result's one JSON object; the last
lines of standard error are the numbers compared, each beside its
limit.  Exits with another code than 0, and prints no result, where no
CUDA card is seen (there is no fall-back to the CPU), and where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` was imported.
"""

import os
import sys
import time

T0 = time.time()   # set-up is counted from the start of the process
# bitwise-reproducible steps, as the port's launcher sets them: cuBLAS
# needs a fixed workspace before CUDA starts
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_forbidden() -> list[str]:
    """Top-level names of the loaded modules that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from potbench import bench, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    result = bench.run(cell, seed=args.seed, seconds=args.seconds,
                       trace_on=bool(args.trace), device="cuda", t0=T0)
    bad = imported_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were imported: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
