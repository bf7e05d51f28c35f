#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card's name and power limit (``nvidia-smi``), and the build of
   every hand-written kernel from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a`` (all sources started together);
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, bitwise; its time (CUDA events), the
   plain version's, one library call computing the same table
   (``torch.matmul`` of 0/1 bf16 masks, a yardstick the port never
   calls) and its bound (the larger of bytes over the memory rate and
   word-pair operations over the int32 rate);
3. the main path: a stream of STAMP vacation-high batches
   (``vacation_like(update_pct=90)``, 1,048,576 objects as in
   ``-r1048576``, K = 1024 transactions, 8 lanes) through
   ``PotSession(..., engine="pcc", device="cuda").run_stream``, with the
   kernels' launch counts from that run alone (each must be > 0);
4. the same stream through the port on the CPU (scatter-min
   formulation): fingerprint, replay log and every trace field must be
   bitwise equal to the card's, and the final store must equal a plain
   numpy serial interpreter's;
5. the host time of each step of one full-rung round (synchronised).

The second line from the end is the kernels' JSON summary and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device it exits 1 at once and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_OBJECTS = 1 << 20     # STAMP vacation -r1048576
K = 1024                # transactions per batch
N_LANES = 8
N_BATCHES = 4
SEED = 0
STRIP = 256             # the compact rung below K = 1024

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 outside the tensor cores = 132 SMs x 128 lanes x 2 x
# 1.98 GHz, and an SM has 64 int32 lanes, so 132 x 64 x 1.98e9 int32
# operations/s.  One LOP3 instruction computes acc | (a & b): one
# operation per word pair.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/conflict.cu"
REPLACES = {
    "conflict_matrix_bits_pair": "src/repro/kernels/conflict.py:132",
    "conflict_matrix_bits_delta": "src/repro/kernels/conflict.py:98",
}


def log(*parts):
    print(*parts, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    procs = {name: _build.start_build(name) for name in _build.SOURCES}
    for name, started in procs.items():
        _build.finish_build(name, started)
        _build.load(name)
    log(f"build: {len(procs)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def dense_mask(addrs, n, n_objects):
    """(K, O) bf16 0/1 mask of each row's first n valid addresses."""
    import torch
    k, length = addrs.shape
    valid = torch.arange(length, device=addrs.device)[None, :] < n[:, None]
    tgt = torch.where(valid, addrs.long(), n_objects)
    mask = torch.zeros((k, n_objects + 1), dtype=torch.bfloat16,
                       device=addrs.device)
    mask.scatter_(1, tgt, 1.0)
    return mask[:, :n_objects].contiguous()


def phase_kernels(batch):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from repro_torch.core.tstore import make_store
    from repro_torch.core.txn import run_all
    from repro_torch.kernels import conflict, ops, ref

    store = make_store(N_OBJECTS, device="cuda")
    res = run_all(batch, store.values)
    foot, write = ops.packed_footprints(res.raddrs, res.rn, res.waddrs,
                                        res.wn, N_OBJECTS)
    w = foot.shape[1]
    fmask = torch.maximum(dense_mask(res.raddrs, res.rn, N_OBJECTS),
                          dense_mask(res.waddrs, res.wn, N_OBJECTS))
    wmask = dense_mask(res.waddrs, res.wn, N_OBJECTS)
    library_table = (fmask @ wmask.T) > 0.5
    rows = torch.arange(K - STRIP, K, device="cuda")  # the pending suffix
    results = {}

    # --- pair: the (C, K) and (K, C) strips of a compact round ----------
    strips = [(foot[rows], write, fmask[rows], wmask),
              (foot, write[rows], fmask, wmask[rows])]
    ms, plain_ms, lib_ms, bnd, err = [], [], [], [], 0
    for a, b, am, bm in strips:
        out = conflict.conflict_matrix_bits_pair(a, b)
        plain = ref.conflict_matrix_bits_pair_ref(a, b)
        torch.cuda.synchronize()
        err = max(err, int((out.int() - plain.int()).abs().max()))
        assert torch.equal(out, plain), "pair kernel != plain version"
        assert torch.equal(out, (am @ bm.T) > 0.5), "pair != dense matmul"
        ms.append(cuda_time_ms(
            lambda: conflict.conflict_matrix_bits_pair(a, b), 50))
        plain_ms.append(cuda_time_ms(
            lambda: ref.conflict_matrix_bits_pair_ref(a, b), 2, 1))
        lib_ms.append(cuda_time_ms(lambda: am @ bm.T, 10))
        m, n = a.shape[0], b.shape[0]
        bnd.append(bound(m * n * w, (m + n) * w * 4 + m * n))
        log(f"pair ({m}, {n}) x W={w}: kernel {ms[-1]:.4f} ms, plain "
            f"{plain_ms[-1]:.4f} ms, matmul {lib_ms[-1]:.4f} ms, bound "
            f"{bnd[-1][0]:.4f} ms ({bnd[-1][1]}), "
            f"{int(out.sum())} conflicting pairs, bitwise equal")
    results["conflict_matrix_bits_pair"] = dict(
        max_abs_err=err, ms=float(np.mean(ms)), plain_ms=float(np.mean(
            plain_ms)), bound_ms=float(np.mean([b[0] for b in bnd])),
        bound_by=bnd[0][1], library_ms=float(np.mean(lib_ms)))

    # --- delta: the full rung, about half the rows live -----------------
    rng = np.random.default_rng(SEED)
    old = torch.from_numpy(rng.random((K, K)) < 0.5).cuda()
    live = torch.from_numpy(rng.random(K) < 0.5).cuda()
    out = conflict.conflict_matrix_bits_delta(foot, write, old, live)
    plain = ref.conflict_matrix_bits_delta_ref(foot, write, old, live)
    torch.cuda.synchronize()
    err = int((out.int() - plain.int()).abs().max())
    assert torch.equal(out, plain), "delta kernel != plain version"
    refresh = live[:, None] | live[None, :]
    assert torch.equal(out, torch.where(refresh, library_table, old))
    t = cuda_time_ms(
        lambda: conflict.conflict_matrix_bits_delta(foot, write, old, live),
        20)
    t_plain = cuda_time_ms(
        lambda: ref.conflict_matrix_bits_delta_ref(foot, write, old, live),
        2, 1)
    t_lib = cuda_time_ms(lambda: fmask @ wmask.T, 10)
    n_refresh = int(refresh.sum())
    b = bound(n_refresh * w, 2 * K * w * 4 + 2 * K * K + K)
    log(f"delta K={K} x W={w}, {int(live.sum())} live rows, {n_refresh} "
        f"refreshed entries: kernel {t:.4f} ms, plain {t_plain:.4f} ms, "
        f"matmul {t_lib:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
        f"bitwise equal")
    results["conflict_matrix_bits_delta"] = dict(
        max_abs_err=err, ms=t, plain_ms=t_plain, bound_ms=b[0],
        bound_by=b[1], library_ms=t_lib)
    del fmask, wmask, library_table
    torch.cuda.empty_cache()
    return results


def run_stream(wls, device):
    from repro_torch.core.session import PotSession
    s = PotSession(N_OBJECTS, engine="pcc", n_lanes=N_LANES, device=device)
    traces = s.run_stream([w.batch for w in wls], [w.lanes for w in wls])
    return s, traces


def phase_main_path(wls):
    import torch
    from repro_torch.kernels import conflict
    torch.cuda.synchronize()
    conflict.reset_launches()
    t0 = time.perf_counter()
    session, traces = run_stream(wls, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(conflict.LAUNCHES)
    rounds = [int(t.rounds) for t in traces]
    n_txns = sum(w.batch.n_txns for w in wls)
    log(f"main path: {n_txns} txns in {N_BATCHES} batches of K={K}, "
        f"O={N_OBJECTS}: {seconds:.3f} s, {n_txns / seconds:.1f} txns/s, "
        f"rounds per batch {rounds} ({seconds / sum(rounds) * 1e3:.2f} ms "
        f"per round), launches {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    return session, traces, launches


def phase_held_to_account(wls, gpu_session, gpu_traces):
    from repro_torch import convert
    from repro_torch.core import oracle
    from repro_torch.core.engine import TRACE_FIELDS
    from repro_torch.core.sequencer import RoundRobinSequencer

    t0 = time.perf_counter()
    cpu_session, cpu_traces = run_stream(wls, "cpu")
    fp = gpu_session.fingerprint()
    assert fp == cpu_session.fingerprint(), "fingerprints differ"
    assert gpu_session.replay_log() == cpu_session.replay_log()
    for i, (g, c) in enumerate(zip(gpu_traces, cpu_traces)):
        g, c = convert.trace_to_numpy(g), convert.trace_to_numpy(c)
        for f in TRACE_FIELDS:
            assert np.array_equal(g[f], c[f]), f"batch {i} trace.{f}"
    t_cpu = time.perf_counter() - t0

    seqr = RoundRobinSequencer(n_root_lanes=N_LANES)
    values, versions, gv = oracle.serial_execute(
        np.zeros((N_OBJECTS, 1), np.int32), np.zeros(N_OBJECTS, np.int32),
        0, [convert.batch_to_numpy(w.batch) for w in wls],
        [seqr.order_for(w.lanes.tolist()) for w in wls])
    store = convert.store_to_numpy(gpu_session.store)
    assert np.array_equal(store["values"], values), "values != oracle"
    assert np.array_equal(store["versions"], versions), "versions != oracle"
    assert int(store["gv"]) == gv == N_BATCHES * K
    log(f"held to account: card == CPU run ({t_cpu:.1f} s) on fingerprint "
        f"{fp:#010x}, replay log and all {len(TRACE_FIELDS)} trace fields; "
        f"store == numpy serial oracle (gv {gv})")


def phase_round_breakdown(wl):
    """Host time of each step of one full-rung round at the main path's
    shapes (every row live, as in round 0), each step synchronised."""
    import torch
    from repro_torch.core import protocol
    from repro_torch.core.tstore import make_store
    from repro_torch.core.txn import pad_batch, run_live, run_txn
    from repro_torch.kernels import ops

    batch = pad_batch(wl.batch.to("cuda"), K, 16)
    store = make_store(N_OBJECTS, device="cuda")
    rs = protocol.init_round_state(batch, store.values.clone(),
                                   store.versions.clone())
    live = batch.n_ins > 0
    order = rank = torch.arange(K, device="cuda")
    rs = protocol.refresh_round_state(rs, batch, live)
    res = rs.res
    committing = protocol.prefix_commit(res, rs.conflict, order, rank, 0,
                                        N_OBJECTS, live)
    steps = {
        "read phase (run_live, K x L)": lambda: run_live(
            batch, rs.values, live, res),
        "pack footprints": lambda: ops.update_packed_footprints(
            rs.foot_bits, rs.write_bits, res.raddrs, res.rn, res.waddrs,
            res.wn, live, N_OBJECTS),
        "delta kernel": lambda: ops.conflict_matrix_delta(
            rs.foot_bits, rs.write_bits, rs.conflict, live),
        "prefix decision": lambda: protocol.prefix_commit(
            res, rs.conflict, order, rank, 0, N_OBJECTS, live),
        "fused write-back": lambda: protocol.fused_write_back(
            rs.values.clone(), rs.versions.clone(), res.waddrs, res.wvals,
            res.wn, committing, rank, rank + 1),
        "live promotion (run_txn + apply_writes)": lambda: (
            protocol.apply_writes(rs.values.clone(), rs.versions.clone(),
                                  *run_txn(batch.rows(order[5]), rs.values,
                                           N_OBJECTS)[2:], 6)),
    }
    total = 0.0
    log("round breakdown (full rung, all rows live), host ms per step:")
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        total += ms
        log(f"  {ms:9.3f} ms  {name}")
    log(f"  {total:9.3f} ms  sum")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import workloads as W

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.use_deterministic_algorithms(True)
    phase_build()

    wls = [W.vacation_like(n_txns=K, n_objects=N_OBJECTS, n_lanes=N_LANES,
                           update_pct=90, seed=SEED + b, device="cpu")
           for b in range(N_BATCHES + 1)]
    stream, extra = wls[:N_BATCHES], wls[N_BATCHES]
    kernels = phase_kernels(stream[0].batch.to("cuda"))
    gpu_session, gpu_traces, launches = phase_main_path(stream)
    phase_held_to_account(stream, gpu_session, gpu_traces)
    phase_round_breakdown(extra)

    summary = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    **kernels[name]) for name in REPLACES]
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
