"""The readings the limits of ``correct`` are set from, on the card at a
cell's own sizes (no measured window: the checked steps alone).

    python potbench/control.py --workload <cell> --seeds 11,12,... [--faults N] [--control N] [--precision KIND]

For every seed: the program's readings (a sound run) against the float32
reference's.  For the first N seeds also each planted fault of
``faults.py`` but ``unchanged`` (which reads 1 by construction) and the
control: the reference put in the program's place at a lower precision
(``reference.common.Precision``), by default its products in float8
e4m3, the nearest precision below the configuration's bf16, or with
``--precision bfloat16_scores`` attention's products in bf16, the
nearest below its float32 scores.  Each reading is one JSON line on
standard output."""

import os
import sys
import time

os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--precision", default="float8_e4m3fn",
                    choices=("float8_e4m3fn", "bfloat16_scores"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from potbench import bench, faults, spec

    cell = spec.load_cell(ROOT, args.workload)
    device = torch.device("cuda")

    def program(seed, wrap=None):
        prog = bench.build(cell, seed, device)
        if wrap is not None:
            prog.step = wrap(prog.step)
        out = bench.first_steps(prog, cell.traffic)
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        return out

    from repro_torch.models import lm

    from potbench.reference.common import flatten
    tree = lm.init_params(None, bench.model_config(cell.config),
                          dtype=torch.float32, device="meta")
    print(json.dumps({"cell": cell.name,
                      "leaves": [p for p, _ in flatten(tree)]}), flush=True)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.time()
        runs = {"sound": program(seed)}
        t_prog = time.time() - t
        t = time.time()
        ref = bench.reference(cell, seed, device)
        t_ref = time.time() - t
        if n < args.faults:
            for name in ("half_batch", "doubled_leaf"):
                runs[name] = program(seed, faults.FAULTS[name])
        if n < args.control:
            runs[f"control {args.precision}"] = bench.reference(
                cell, seed, device, args.precision)
        for name, r in runs.items():
            grad, change = bench.leaf_gaps(r, ref)
            print(json.dumps({"cell": cell.name, "seed": seed, "run": name,
                              **bench.gaps(r, ref), "losses": r.losses,
                              "ref_losses": ref.losses,
                              "program_s": t_prog, "reference_s": t_ref,
                              "leaf_grad_gaps": grad,
                              "leaf_change_gaps": change,
                              "ref_grad_norms": ref.grad_norms}),
                  flush=True)

    return 0


if __name__ == "__main__":
    sys.exit(main())
