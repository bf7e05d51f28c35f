"""The hand-written CUDA kernels against their plain versions, on the
card: bitwise equality on ragged and main-path shapes (the AdamW and
validation kernels also on unaligned views, AdamW on a leaf of more than
2^31 bytes), launch counting, a small stream through the card's matrix
formulation equal to the CPU's scatter-min run for each of the four
engines, ``ops.validate`` on the card against the CPU, the cross-batch
validation strip on both routes and a pipelined PCC stream against the
CPU's, the sharded store's kernels at W_s = 4,096 (their OR over shards
against the dense kernels), sharded sessions and a replica's failover on
the card, the serving
session on the card against the CPU's, the AdamW kernel at tensor-
parallel shards' shapes (attention and the MLP; the mixers, whisper's
encoder and cross-attention) and the paged commit into a K/V cache's
head shard, a Pot train step on the card
run twice, bitwise, the DP step of the other layer kinds (the AdamW
kernel at their leaves) twice, bitwise, and deepseek-moe-16b's MoE
dispatch at its full shape in deterministic mode against the CPU's.
Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, not at import).  Run on a GPU machine
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import os

# cuBLAS is deterministic under torch's deterministic mode only with a
# fixed workspace, set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import convert
from repro_torch.core import workloads as W
from repro_torch.core.engine import TRACE_FIELDS
from repro_torch.core.session import PotSession
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.kernels import (conflict, fused_adamw, kv_commit, ops, ref,
                                 validate)
from repro_torch.models import lm
from repro_torch.serve.session import Session
from repro_torch.train import init_state, make_pot_dp_step, make_train_step
from repro_torch.tree import leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(rng, rows, w, density, device):
    words = rng.integers(-(1 << 31), 1 << 31, (rows, w), dtype=np.int64)
    bits = np.where(rng.random((rows, w)) < density, words, 0)
    return torch.from_numpy(bits.astype(np.int32)).to(device)


@pytest.mark.parametrize("m,n,w,density", [
    (1, 1, 1, 0.5), (13, 40, 7, 0.1), (70, 65, 33, 0.05),
    (64, 64, 32, 0.01), (130, 200, 1000, 0.001), (256, 1024, 4096, 1e-4),
    # the engines' strips at the main path's W: every compact rung of
    # K = 1024 both ways, DeSTM's 8 x 8 retry-wave strips, and the square
    # table
    (256, 1024, 32768, 1e-3), (1024, 256, 32768, 1e-3),
    (64, 1024, 32768, 1e-3), (1024, 64, 32768, 1e-3),
    (16, 1024, 32768, 1e-3), (1024, 16, 32768, 1e-3),
    (8, 8, 32768, 5e-3), (1024, 1024, 32768, 1e-3),
    # W below one slice, and W not a multiple of it (nor of 4)
    (70, 65, 1, 0.5), (300, 130, 7, 0.1), (8, 8, 33, 0.05),
    (130, 200, 32767, 1e-3),
    # the sharded store's strips at the shard-local W_s = 4,096 (8 shards
    # of 1,048,576 objects)
    (256, 1024, 4096, 1e-3), (1024, 256, 4096, 1e-3),
    (1024, 1024, 4096, 1e-3),
])
def test_pair_kernel_equals_plain(cuda, m, n, w, density):
    rng = np.random.default_rng(m + n + w)
    a, b = _bits(rng, m, w, density, cuda), _bits(rng, n, w, density, cuda)
    conflict.reset_launches()
    out = conflict.conflict_matrix_bits_pair(a, b)
    torch.cuda.synchronize()
    assert conflict.LAUNCHES["conflict_matrix_bits_pair"] == 1
    assert conflict.SHAPES[("conflict_matrix_bits_pair", m, n, w)] == 1
    assert torch.equal(out, ref.conflict_matrix_bits_pair_ref(a, b))
    # a second call reuses the combine's scratch after the first
    assert torch.equal(conflict.conflict_matrix_bits_pair(a, b), out)


def test_conflict_kernels_on_two_streams(cuda):
    """Launches in flight on two streams at once keep their own scratch
    and row lists."""
    rng = np.random.default_rng(7)
    k, w = 1000, 32768
    a, b = _bits(rng, k, w, 1e-3, cuda), _bits(rng, k, w, 1e-3, cuda)
    old = torch.from_numpy(rng.random((k, k)) < 0.5).to(cuda)
    lives = [torch.from_numpy(rng.random(k) < f).to(cuda) for f in (0.5, 0.1)]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for s, live in zip(streams, lives):
            with torch.cuda.stream(s):
                outs.append((conflict.conflict_matrix_bits_pair(a, b),
                             conflict.conflict_matrix_bits_delta(a, b, old,
                                                                 live), live))
    torch.cuda.synchronize()
    pair = ref.conflict_matrix_bits_pair_ref(a, b)
    for out_pair, out_delta, live in outs:
        assert torch.equal(out_pair, pair)
        assert torch.equal(out_delta, ref.conflict_matrix_bits_delta_ref(
            a, b, old, live))


@pytest.mark.parametrize("k,w,live_frac", [
    (1, 1, 1.0), (64, 32, 0.0), (100, 70, 0.3), (257, 300, 0.02),
    (1024, 2048, 0.5),
    # the full rung at the main path's W, about half and a quarter live;
    # a ragged K with no row, every row, or only its last row live
    (1024, 32768, 0.5), (1024, 32768, 0.25),
    (1000, 32768, 0.0), (1000, 32768, 1.0), (1000, 32768, "last"),
    (1000, 32767, 0.3),
    # the sharded store's full rung at W_s = 4,096
    (1024, 4096, 0.5), (1024, 4096, 0.25),
])
def test_delta_kernel_equals_plain(cuda, k, w, live_frac):
    rng = np.random.default_rng(k + w)
    a = _bits(rng, k, w, 0.01 if w < 32768 else 1e-3, cuda)
    b = _bits(rng, k, w, 0.005 if w < 32768 else 1e-3, cuda)
    old = torch.from_numpy(rng.random((k, k)) < 0.5).to(cuda)
    if live_frac == "last":
        live = torch.zeros(k, dtype=torch.bool, device=cuda)
        live[-1] = True
    else:
        live = torch.from_numpy(rng.random(k) < live_frac).to(cuda)
    conflict.reset_launches()
    out = conflict.conflict_matrix_bits_delta(a, b, old, live)
    torch.cuda.synchronize()
    assert conflict.LAUNCHES["conflict_matrix_bits_delta"] == 1
    assert conflict.LAUNCHES["conflict_matrix_bits_pair"] == 0
    assert torch.equal(out, ref.conflict_matrix_bits_delta_ref(a, b, old,
                                                               live))
    assert torch.equal(conflict.conflict_matrix_bits_delta(a, b, old, live),
                       out)


def test_stream_on_card_equals_cpu(cuda):
    wls = [W.vacation_like(n_txns=k, n_objects=4096, n_lanes=8, seed=s,
                           device="cpu") for s, k in enumerate((300, 77))]
    runs = []
    for dev in (cuda, "cpu"):
        s = PotSession(4096, engine="pcc", n_lanes=8, device=dev)
        conflict.reset_launches()
        traces = s.run_stream([w.batch for w in wls], [w.lanes for w in wls])
        runs.append((s, traces, dict(conflict.LAUNCHES)))
    (g, g_tr, launches), (c, c_tr, cpu_launches) = runs
    assert min(launches.values()) > 0 and max(cpu_launches.values()) == 0
    assert g.fingerprint() == c.fingerprint()
    assert g.replay_log() == c.replay_log()
    for gt, ct in zip(g_tr, c_tr):
        gt, ct = convert.trace_to_numpy(gt), convert.trace_to_numpy(ct)
        for f in TRACE_FIELDS:
            np.testing.assert_array_equal(gt[f], ct[f], err_msg=f)


@pytest.mark.parametrize("k,w", [(1, 1), (8, 128), (1000, 32767),
                                 (1024, 32768), (1024, 4096)])
def test_validate_kernel_equals_plain(cuda, k, w):
    rng = np.random.default_rng(k + w)
    read = _bits(rng, k, w, 3e-4, cuda)
    written = _bits(rng, 1, w, 0.01, cuda)[0]
    validate.reset_launches()
    out = validate.validate_bitsets(read, written)
    torch.cuda.synchronize()
    assert validate.LAUNCHES["validate_bitsets"] == 1
    assert torch.equal(out, ref.validate_bitsets_ref(read, written))


def test_validate_kernel_on_unaligned_views(cuda):
    """Bases 4 bytes past a 16-byte boundary take the one-word loop."""
    rng = np.random.default_rng(1)
    k, w = 37, 260
    flat = _bits(rng, 1, k * w + 1, 0.002, cuda)[0]
    read = flat[1:].view(k, w)
    written = _bits(rng, 1, w + 1, 0.05, cuda)[0][1:]
    assert read.data_ptr() % 16 and written.data_ptr() % 16
    out = validate.validate_bitsets(read, written)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.validate_bitsets_ref(read, written))
    assert out.any() and not out.all()


def test_ops_validate_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(2)
    ra = torch.from_numpy(rng.integers(0, 1 << 20, (300, 16)).astype(
        np.int32))
    rn = torch.from_numpy(rng.integers(0, 17, 300).astype(np.int32))
    wa = ra[:40].reshape(-1)[rng.permutation(640)]
    got = ops.validate(ra.to(cuda), rn.to(cuda), wa.to(cuda), 640, 1 << 20)
    exp = ops.validate(ra, rn, wa, 640, 1 << 20)
    assert torch.equal(got.cpu(), exp) and exp.any() and not exp.all()


@pytest.mark.parametrize("route", ["validate", "pair"])
def test_spec_read_invalid_strip_on_card(cuda, route):
    """The cross-batch validation strip at the main path's shape (K =
    1024 read sets of 16 slots against the dirty words of 1,048,576
    objects, W = 32,768), on both routes: the validation kernel, and a
    (1024, 1) strip of the pair kernel.  Bitwise against the kernel's
    plain version and against the CPU's dense version gather; the entry
    point on the card takes the validation kernel."""
    k, n_obj = 1024, 1 << 20
    rng = np.random.default_rng(5)
    raddrs = torch.from_numpy(rng.integers(0, n_obj, (k, 16)).astype(
        np.int32))
    rn = torch.from_numpy(rng.integers(0, 17, k).astype(np.int32))
    versions = rng.integers(0, 600, n_obj).astype(np.int32)
    versions[31::32] = 700            # every bit-31 address dirty
    versions = torch.from_numpy(versions)
    snap = torch.tensor(598, dtype=torch.int32)
    plain = ops.spec_read_invalid(raddrs, rn, versions, snap, n_obj)
    assert plain.any() and not plain.all()
    g = lambda t: t.to(cuda)
    dwords = ops.spec_dirty_words(g(versions), g(snap), n_obj)
    assert torch.equal(dwords.cpu(),
                       ops.spec_dirty_words(versions, snap, n_obj))
    read_bits = validate.pack_addr_sets(g(raddrs), g(rn), n_obj)
    if route == "validate":
        out = validate.validate_bitsets(read_bits, dwords)
        kernel_plain = ref.validate_bitsets_ref(read_bits, dwords)
    else:
        out = conflict.conflict_matrix_bits_pair(read_bits, dwords[None])
        kernel_plain = ref.conflict_matrix_bits_pair_ref(read_bits,
                                                         dwords[None])
        out, kernel_plain = out[:, 0], kernel_plain[:, 0]
    torch.cuda.synchronize()
    assert torch.equal(out, kernel_plain)
    assert torch.equal(out.cpu(), plain)
    validate.reset_launches()
    got = ops.spec_read_invalid(g(raddrs), g(rn), g(versions), g(snap),
                                n_obj)
    torch.cuda.synchronize()
    assert validate.LAUNCHES["validate_bitsets"] == 1
    assert torch.equal(got.cpu(), plain)


def test_pipelined_session_on_card_equals_cpu(cuda):
    """A pipelined PCC stream (depth 2) on the card equals the same
    stream on the CPU in every trace field, ``spec_*`` included, and the
    card's serial run in every field but ``spec_*``; the speculation goes
    through the delta kernel and the validation kernel."""
    wls = [W.vacation_like(n_txns=k, n_objects=4096, n_lanes=8, seed=s,
                           update_pct=90, device="cpu")
           for s, k in enumerate((256, 200, 256))]
    batches, lanes = [w.batch for w in wls], [w.lanes for w in wls]
    runs = []
    for dev, depth in ((cuda, 2), ("cpu", 2), (cuda, 0)):
        s = PotSession(4096, engine="pcc", n_lanes=8, pipeline_depth=depth,
                       device=dev)
        conflict.reset_launches()
        validate.reset_launches()
        traces = s.run_stream(batches, lanes)
        runs.append((s, traces, dict(conflict.LAUNCHES,
                                     **validate.LAUNCHES)))
    (g, g_tr, launches), (c, c_tr, _), (serial, s_tr, _) = runs
    assert min(launches.values()) > 0, launches
    assert sum(int(t.spec_executed) for t in g_tr) == 712
    assert g.fingerprint() == c.fingerprint() == serial.fingerprint()
    assert g.replay_log() == c.replay_log() == serial.replay_log()
    for gt, ct, st in zip(g_tr, c_tr, s_tr):
        gt, ct = convert.trace_to_numpy(gt), convert.trace_to_numpy(ct)
        st = convert.trace_to_numpy(st)
        for f in TRACE_FIELDS:
            np.testing.assert_array_equal(gt[f], ct[f], err_msg=f)
            if not f.startswith("spec_"):
                np.testing.assert_array_equal(gt[f], st[f], err_msg=f)


@pytest.mark.parametrize("engine", ["occ", "pogl", "destm"])
def test_engine_stream_on_card_equals_cpu(cuda, engine):
    """Each engine's small ragged stream on the card (matrix formulation
    for OCC) equals its CPU run (scatter-min) in every trace field, and
    reaches the conflict kernels it should."""
    wls = [W.counters(n_txns=k, n_objects=512, n_reads=2, n_writes=2,
                      n_lanes=8, skew=1.0, seed=s, device="cpu")
           for s, k in enumerate((300, 77))]
    runs = []
    for dev in (cuda, "cpu"):
        s = PotSession(512, engine=engine, n_lanes=8, device=dev)
        conflict.reset_launches()
        traces = s.run_stream([w.batch for w in wls], [w.lanes for w in wls])
        runs.append((s, traces, dict(conflict.LAUNCHES)))
    (g, g_tr, launches), (c, c_tr, cpu_launches) = runs
    assert max(cpu_launches.values()) == 0
    if engine == "occ":
        assert min(launches.values()) > 0, launches
    elif engine == "destm":
        assert launches["conflict_matrix_bits_pair"] > 0, launches
    assert g.fingerprint() == c.fingerprint()
    assert g.replay_log() == c.replay_log()
    for gt, ct in zip(g_tr, c_tr):
        gt, ct = convert.trace_to_numpy(gt), convert.trace_to_numpy(ct)
        for f in TRACE_FIELDS:
            np.testing.assert_array_equal(gt[f], ct[f], err_msg=f)


def test_or_over_shards_equals_dense_kernels(cuda):
    """At the main path's size (K = 1024, O = 1,048,576) in 8 shards of
    W_s = 4,096 words: the OR of the per-shard tables, deltas and
    cross-batch verdicts equals the dense kernels' at W = 32,768, and
    the sharded twins launch each kernel once per shard."""
    from repro_torch.core.tstore import StoreLayout
    from repro_torch.core.txn import run_all
    k, n_obj, shards = 1024, 1 << 20, 8
    layout = StoreLayout(n_obj, shards)
    wl = W.vacation_like(n_txns=k, n_objects=n_obj, n_lanes=8,
                         update_pct=90, seed=0, device="cpu")
    res = run_all(wl.batch.to(cuda),
                  torch.zeros((n_obj, 1), dtype=torch.int32, device=cuda))
    foot, write = ops.packed_footprints(res.raddrs, res.rn, res.waddrs,
                                        res.wn, n_obj)
    sfoot, swrite = ops.packed_footprints_sharded(
        res.raddrs, res.rn, res.waddrs, res.wn, layout)
    assert sfoot.shape == (shards, k, 4096)
    conflict.reset_launches()
    table = ops.conflict_matrix_sharded(sfoot, swrite)
    torch.cuda.synchronize()
    assert conflict.SHAPES[("conflict_matrix_bits_pair", k, k, 4096)] \
        == shards
    assert torch.equal(table, conflict.conflict_matrix_bits(foot, write))
    rng = np.random.default_rng(3)
    old = torch.from_numpy(rng.random((k, k)) < 0.5).to(cuda)
    live = torch.from_numpy(rng.random(k) < 0.5).to(cuda)
    got = ops.conflict_matrix_delta_sharded(sfoot, swrite, old, live)
    assert torch.equal(got, conflict.conflict_matrix_bits_delta(
        foot, write, old, live))
    idx = torch.nonzero(live)[:256, 0]
    valid = torch.ones_like(idx, dtype=torch.bool)
    strips = ops.conflict_matrix_delta_compact_sharded(
        sfoot, swrite, old, idx, valid)
    assert torch.equal(strips, ops.conflict_matrix_delta_compact(
        foot, write, old, idx, valid))
    versions = torch.from_numpy(rng.integers(0, 12, n_obj).astype(
        np.int32)).to(cuda)
    sversions = torch.nn.functional.pad(
        versions, (0, layout.padded_objects - n_obj)).view(shards, -1)
    validate.reset_launches()
    inv = ops.spec_read_invalid_sharded(res.raddrs, res.rn, sversions, 10,
                                        layout)
    torch.cuda.synchronize()
    assert validate.LAUNCHES["validate_bitsets"] == shards
    assert torch.equal(inv, ops.spec_read_invalid(res.raddrs, res.rn,
                                                  versions, 10, n_obj))
    assert inv.any() and not inv.all()


def test_sharded_session_on_card_equals_dense_and_cpu(cuda):
    """``PotSession(shards=8)`` on the card: serial and pipelined (depth
    2) streams equal the card's dense run and the CPU's sharded run in
    every trace field (``spec_*`` but against the serial run), through
    every conflict kernel and, pipelined, the validation kernel."""
    wls = [W.vacation_like(n_txns=k, n_objects=4096, n_lanes=8, seed=s,
                           update_pct=90, device="cpu")
           for s, k in enumerate((256, 200, 256))]
    batches, lanes = [w.batch for w in wls], [w.lanes for w in wls]
    runs = {}
    for name, dev, shards, depth in (
            ("card", cuda, 8, 0), ("card dense", cuda, 1, 0),
            ("cpu", "cpu", 8, 0), ("card piped", cuda, 8, 2),
            ("cpu piped", "cpu", 8, 2)):
        s = PotSession(4096, engine="pcc", n_lanes=8, shards=shards,
                       pipeline_depth=depth, device=dev)
        conflict.reset_launches()
        validate.reset_launches()
        traces = s.run_stream(batches, lanes)
        runs[name] = (s, [convert.trace_to_numpy(t) for t in traces],
                      dict(conflict.LAUNCHES, **validate.LAUNCHES))
    base, base_tr, _ = runs["card dense"]
    for name, (s, traces, launches) in runs.items():
        assert s.fingerprint() == base.fingerprint(), name
        assert s.replay_log() == base.replay_log(), name
        for a, b in zip(traces, base_tr):
            for f in TRACE_FIELDS:
                if s.pipeline_depth == 0 or not f.startswith("spec_"):
                    np.testing.assert_array_equal(a[f], b[f],
                                                  err_msg=f"{name} {f}")
        if name.startswith("card"):
            assert launches["conflict_matrix_bits_pair"] > 0, name
            assert launches["conflict_matrix_bits_delta"] > 0, name
            assert (launches["validate_bitsets"] > 0) == \
                (s.pipeline_depth > 0), name
    piped, cpu_piped = runs["card piped"][1], runs["cpu piped"][1]
    for a, b in zip(piped, cpu_piped):
        for f in TRACE_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_replica_failover_on_card(tmp_path, cuda):
    """A replica on the card killed mid-stream ("raise") and resumed from
    its snapshots ends bitwise equal to an uninterrupted one, at 8
    shards and depth 2."""
    from repro_torch.core import (FaultInjected, FaultPlan, IngressPool,
                                  run_replica, trace_digest)
    from repro_torch.core.ingress import programs_from_batch
    wl = W.vacation_like(n_txns=600, n_objects=4096, n_lanes=8, seed=4,
                         update_pct=90, device="cpu")
    pool = IngressPool(capacity=1024)
    for p, lane in zip(programs_from_batch(wl.batch), wl.lanes.tolist()):
        pool.admit(p, lane=int(lane))
    journal = pool.arrival_journal()
    kw = dict(n_objects=4096, engine="pcc", n_lanes=8, shards=8,
              pipeline_depth=2, budgets=(128, 200), device="cuda")
    base = run_replica(journal, directory=str(tmp_path / "base"),
                       snapshot_every=0, **kw)
    with pytest.raises(FaultInjected):
        run_replica(journal, directory=str(tmp_path / "v"),
                    snapshot_every=1, fault_plan=FaultPlan(
                        kill_batch=2, kill_phase="execute", action="raise"),
                    **kw)
    rec = run_replica(journal, directory=str(tmp_path / "v"),
                      snapshot_every=1, resume=True, **kw)
    assert rec.session.restored_from == 1
    assert rec.session.fingerprint() == base.session.fingerprint()
    assert rec.session.replay_log() == base.session.replay_log()
    bd = [trace_digest(t) for t in base.session.traces]
    rd = [trace_digest(t) for t in rec.session.traces]
    assert rd == bd[len(bd) - len(rd):]


def _kv_inputs(rng, p, page, h, s, dtype, device):
    """A draw with repeated pages and rows, skipped slots, arbitrary
    sequence numbers and page / row ids past either end."""
    t = lambda a, dt=torch.int32: torch.from_numpy(
        np.asarray(a)).to(dtype=dt, device=device)
    return (t(rng.normal(size=(p, page, h)), torch.float32).to(dtype),
            t(rng.integers(0, 5, p)), t(rng.normal(size=(s, h)) * 100,
                                        torch.float32),
            t(rng.integers(-2, p + 2, s)), t(rng.integers(-page - 2,
                                                          page + 2, s)),
            t(rng.permutation(s) + 1), t(rng.random(s) < 0.8))


@pytest.mark.parametrize("p,page,h,s", [
    (1, 1, 1, 1), (4, 2, 8, 3), (16, 8, 128, 8), (128, 16, 8, 8),
    (64, 4, 1280, 300),
    # one slot; H not a multiple of 4 (the row copy's scalar tail, and
    # rows not 16-byte aligned); S over several staged chunks of slots
    (64, 16, 1280, 1), (8, 4, 7, 9), (32, 8, 1283, 40), (16, 4, 12, 4097),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_commit_kernel_equals_plain(cuda, p, page, h, s, dtype):
    rng = np.random.default_rng(p + s + h)
    args = _kv_inputs(rng, p, page, h, s, dtype, cuda)
    before = [a.clone() for a in args[:2]]
    kv_commit.reset_launches()
    got_c, got_v = kv_commit.kv_commit(*args)
    torch.cuda.synchronize()
    assert kv_commit.LAUNCHES["kv_commit"] == 1
    exp_c, exp_v = ref.kv_commit_ref(*args)
    assert torch.equal(got_c.view(torch.uint8), exp_c.view(torch.uint8))
    assert torch.equal(got_v, exp_v)
    assert all(torch.equal(a, b) for a, b in zip(args[:2], before))
    # in place, the same result in the caller's buffers
    cache, versions = kv_commit.kv_commit_(*args)
    assert cache is args[0] and torch.equal(cache, exp_c)
    assert torch.equal(versions, exp_v)


@pytest.mark.parametrize("p,page,h,s", [
    # a KV cache's head shard as a row of the commit: stablelm-12b's 8
    # K/V heads of 160 over 8 ranks (one head) and over 2 (four),
    # qwen1.5-32b's 40 of 128 over 8 (five); 8 decode slots, and a
    # ragged step of 3
    (64, 16, 160, 8), (64, 16, 640, 8), (128, 16, 640, 3),
    # a head shard whose width is not a multiple of 4
    (32, 16, 3 * 50 + 1, 5),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_commit_kernel_on_a_head_sharded_cache(cuda, p, page, h, s,
                                                  dtype):
    """The ordered paged commit into a rank's head shard of a decode
    cache, in place, against its plain version."""
    rng = np.random.default_rng(p * h + s)
    args = _kv_inputs(rng, p, page, h, s, dtype, cuda)
    exp_c, exp_v = ref.kv_commit_ref(*args)
    kv_commit.reset_launches()
    cache, versions = kv_commit.kv_commit_(*args)
    torch.cuda.synchronize()
    assert kv_commit.LAUNCHES["kv_commit"] == 1
    assert cache is args[0] and versions is args[1]
    assert torch.equal(cache.view(torch.uint8), exp_c.view(torch.uint8))
    assert torch.equal(versions, exp_v)


def _commit_equals_plain(args):
    got_c, got_v = kv_commit.kv_commit(*args)
    exp_c, exp_v = ref.kv_commit_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got_c.view(torch.uint8), exp_c.view(torch.uint8))
    assert torch.equal(got_v, exp_v)
    return exp_c, exp_v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_commit_kernel_across_chunk_edges(cuda, dtype):
    """4,097 slots on distinct pages but for pairs that straddle the
    kernel's staged chunks of 1,024 slots: the same (page, row) at slots
    1,023 and 1,024, the same page at 2,047 and 2,048 and at 0 and
    4,096, the same (page, row) at 100, 3,000 and 4,095."""
    rng = np.random.default_rng(11)
    s, p, page, h = 4097, 5000, 2, 8
    page_idx, row_idx = np.arange(s), np.zeros(s, np.int64)
    page_idx[1024], page_idx[2048], page_idx[4096] = 1023, 2047, 0
    row_idx[[2047, 4096]] = 1
    page_idx[[3000, 4095]] = 100
    args = _kv_inputs(rng, p, page, h, s, dtype, cuda)
    t = lambda a: torch.from_numpy(a.astype(np.int32)).to(cuda)
    args = (*args[:3], t(page_idx), t(row_idx), args[5],
            t(np.ones(s)))
    exp_c, exp_v = _commit_equals_plain(args)
    assert torch.equal(exp_c[1023, 0], args[2][1024].to(dtype))
    assert exp_v[0] == args[5][4096] and exp_v[100] == args[5][4095]


@pytest.mark.parametrize("case", ["one_row", "all_skipped"])
def test_kv_commit_kernel_on_degenerate_steps(cuda, case):
    """Every slot on one (page, row): the last wins both; every slot
    skipped: nothing changes."""
    rng = np.random.default_rng(12)
    s = 300
    args = list(_kv_inputs(rng, 4, 4, 1280, s, torch.bfloat16, cuda))
    if case == "one_row":
        args[3] = torch.full((s,), 2, dtype=torch.int32, device=cuda)
        args[4] = torch.full((s,), 1, dtype=torch.int32, device=cuda)
        args[6] = torch.ones(s, dtype=torch.int32, device=cuda)
    else:
        args[6] = torch.zeros(s, dtype=torch.int32, device=cuda)
    exp_c, exp_v = _commit_equals_plain(args)
    if case == "one_row":
        assert torch.equal(exp_c[2, 1], args[2][-1].bfloat16())
        assert exp_v[2] == args[5][-1]
    else:
        assert torch.equal(exp_c, args[0]) and torch.equal(exp_v, args[1])


def test_kv_commit_kernel_in_a_cuda_graph(cuda):
    """A commit captured in a CUDA graph runs at replay, not at capture,
    and gives the eager launch's result: the launch path enqueues on the
    capturing stream."""
    rng = np.random.default_rng(13)
    args = _kv_inputs(rng, 128, 16, 8, 8, torch.float32, cuda)
    eager_c, eager_v = kv_commit.kv_commit(*args)
    cache, versions = args[0].clone(), args[1].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        kv_commit.kv_commit_(cache, versions, *args[2:])
    torch.cuda.synchronize()
    assert torch.equal(cache, args[0]) and torch.equal(versions, args[1])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(cache.view(torch.uint8), eager_c.view(torch.uint8))
    assert torch.equal(versions, eager_v)
    assert not torch.equal(versions, args[1])


def test_session_on_card_commits_like_cpu(cuda):
    """Card and CPU sessions fed one logits stream (the CPU's) commit the
    same pages, through the kernel on the card only; the card's own
    logits agree with the CPU's within the reference tolerance."""
    cfg = get_smoke_config("stablelm-12b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    cpu = Session(cfg, params, n_slots=4, max_seq=32, device="cpu")
    card = Session(cfg, lm.params_to(params, cuda), n_slots=4, max_seq=32,
                   device=cuda)
    cpu_decode, card_decode = cpu._decode, card._decode
    fed = []

    def cpu_recording(*a):
        out = cpu_decode(*a)
        fed.append(out[0])
        return out

    def card_fed(*a):
        logits, cache = card_decode(*a)
        np.testing.assert_allclose(logits.float().cpu().numpy(),
                                   fed[-1].float().numpy(), rtol=3e-2,
                                   atol=3e-2)
        return fed[-1].to(cuda), cache

    cpu._decode, card._decode = cpu_recording, card_fed
    for s in range(4):
        cpu.add_request(s, 3 + 7 * s)
        card.add_request(s, 3 + 7 * s)
    kv_commit.reset_launches()
    ptrs = (card.page_meta.data_ptr(), card.page_versions.data_ptr())
    for _ in range(8):
        cpu_tokens = cpu.step()          # records the logits card is fed
        np.testing.assert_array_equal(card.step(), cpu_tokens)
    assert kv_commit.LAUNCHES["kv_commit"] == 8
    # committed in place: the store is never copied
    assert (card.page_meta.data_ptr(),
            card.page_versions.data_ptr()) == ptrs
    assert torch.equal(card.page_meta.cpu(), cpu.page_meta)
    assert torch.equal(card.page_versions.cpu(), cpu.page_versions)
    assert card.fingerprint() == cpu.fingerprint()


def _bits_equal(got, exp):
    return all(a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, exp))


def _adamw_inputs(n, gdtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    p = torch.randn(n, generator=gen, device=device)
    m = torch.randn(n, generator=gen, device=device) * 0.1
    v = torch.rand(n, generator=gen, device=device) * 0.01
    g = torch.randn(n, generator=gen, device=device).to(gdtype)
    return p, m, v, g


@pytest.mark.parametrize("shape", [
    (1,), (3,), (1001, 333), (5120,), (5120, 13824),
    ((1 << 29) + 3,),   # 2.1 GB a tensor: 64-bit offsets, ragged tail
    # the other layer kinds' leaves at full width: mamba2-370m's
    # per-head vectors, conv and in-projection; recurrentgemma-9b's
    # RG-LRU gates and lam, and conv; deepseek-moe-16b's (E, D, F)
    # expert weights and router; whisper-medium's encoder MLP
    (32,), (4, 2304), (1024, 4384), (4096,), (4, 4096),
    (64, 2048, 1408), (2048, 64), (1024, 4096),
    # sizes that are not a multiple of 4: the scalar tail
    (33,), (5, 2303), (7, 9, 13),
])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_equals_plain(cuda, shape, gdtype):
    n = int(np.prod(shape))
    p, m, v, g = (t.reshape(shape) for t in _adamw_inputs(
        n, gdtype, cuda, n % 1000))
    hp = fused_adamw.hp_vector(7, lr=3e-4, b1=0.9, b2=0.999, eps=1e-8,
                               wd=0.1, device=cuda)
    fused_adamw.reset_launches()
    got = fused_adamw.fused_adamw(p, m, v, g, hp)
    torch.cuda.synchronize()
    assert fused_adamw.LAUNCHES["fused_adamw"] == 1
    assert _bits_equal(got, ref.adamw_ref(p, m, v, g, hp))


@pytest.mark.parametrize("shape", [
    # stablelm-12b's tensor-parallel shards: w1/w3 (5120, 13824 / m) at
    # m = 8 whole and with FSDP over 2 data ranks, wq (5120, 640), wo
    # (640, 5120) at m = 8; w1 at m = 2
    (5120, 1728), (2560, 1728), (5120, 640), (640, 5120), (5120, 6912),
    # qwen1.5-32b's at m = 8: w1 (5120, 27392 / 8), its QKV bias shard
    (5120, 3424), (640,),
    # shards whose sizes are not a multiple of 4 (the scalar tail)
    (5120, 1727), (3, 1707), (13,),
])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_at_tensor_parallel_shards(cuda, shape, gdtype):
    """The fused AdamW kernel at the leaves a rank holds under tensor
    parallelism (``lm.local_params``), against its plain version."""
    n = int(np.prod(shape))
    p, m, v, g = (t.reshape(shape) for t in _adamw_inputs(
        n, gdtype, cuda, n % 997))
    hp = fused_adamw.hp_vector(2, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                               wd=0.01, device=cuda)
    fused_adamw.reset_launches()
    got = fused_adamw.fused_adamw(p, m, v, g, hp)
    torch.cuda.synchronize()
    assert fused_adamw.LAUNCHES["fused_adamw"] == 1
    assert _bits_equal(got, ref.adamw_ref(p, m, v, g, hp))


@pytest.mark.parametrize("shape", [
    # mamba2-370m's mixer on a 4-way model axis, whole and with FSDP over
    # 2 data ranks: w_in (1024, 4384 / 4), w_out (2048 / 4, 1024), the
    # norm's block (2048 / 4,)
    (1024, 1096), (512, 1096), (512, 1024), (512, 512), (512,),
    # recurrentgemma-9b's RG-LRU: w_x and w_gate (4096, 4096 / 4), w_out
    # (4096 / 4, 4096), a gate's block (4096 / 4,)
    (4096, 1024), (2048, 1024), (1024, 4096), (1024, 2048), (1024,),
    # whisper-medium's encoder layers and cross-attention: wq, wk, wv
    # (1024, 1024 / 4), wo (1024 / 4, 1024), the encoder MLP's w1 (1024,
    # 4096 / 4) and w2 (4096 / 4, 1024)
    (1024, 256), (512, 256), (256, 1024), (256, 512), (1024, 1024),
])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_at_mixer_and_encoder_shards(cuda, shape, gdtype):
    """The fused AdamW kernel at the mixers', the encoder's and
    cross-attention's leaves a rank holds on a mesh (``lm.local_params``),
    against its plain version."""
    n = int(np.prod(shape))
    p, m, v, g = (t.reshape(shape) for t in _adamw_inputs(
        n, gdtype, cuda, n % 991))
    hp = fused_adamw.hp_vector(4, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                               wd=0.01, device=cuda)
    fused_adamw.reset_launches()
    got = fused_adamw.fused_adamw(p, m, v, g, hp)
    torch.cuda.synchronize()
    assert fused_adamw.LAUNCHES["fused_adamw"] == 1
    assert _bits_equal(got, ref.adamw_ref(p, m, v, g, hp))


@pytest.mark.parametrize("shape", [
    # stablelm-12b's embedding and head by vocab block on a 4-way model
    # axis: embed (100352 / 4, 5120), head (5120, 100352 / 4)
    (25088, 5120), (5120, 25088),
    # pure_dp's 8-way FSDP shards over (data, model) of a (2, 4) mesh:
    # w1 and w3 (5120 / 8, 13824), w2 (13824, 5120 / 8), wq (5120 / 8,
    # 5120)
    (640, 13824), (13824, 640), (640, 5120),
])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_at_vocab_and_pure_dp_shards(cuda, shape, gdtype):
    """The fused AdamW kernel at the vocab blocks of the embedding and
    head and at ``pure_dp``'s FSDP shards (``lm.local_params``), against
    its plain version."""
    n = int(np.prod(shape))
    p, m, v, g = (t.reshape(shape) for t in _adamw_inputs(
        n, gdtype, cuda, n % 983))
    hp = fused_adamw.hp_vector(5, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                               wd=0.01, device=cuda)
    fused_adamw.reset_launches()
    got = fused_adamw.fused_adamw(p, m, v, g, hp)
    torch.cuda.synchronize()
    assert fused_adamw.LAUNCHES["fused_adamw"] == 1
    assert _bits_equal(got, ref.adamw_ref(p, m, v, g, hp))


def test_adamw_kernel_on_unaligned_views(cuda):
    """Views one element into their storage: not 16-byte aligned, so the
    kernel takes its one-element path."""
    p, m, v, g = _adamw_inputs(4099, torch.bfloat16, cuda, 1)
    hp = fused_adamw.hp_vector(3, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                               wd=0.01, device=cuda)
    args = [t[1:] for t in (p, m, v, g)]
    got = fused_adamw.fused_adamw(*args, hp)
    assert _bits_equal(got, ref.adamw_ref(*args, hp))


@pytest.mark.parametrize("shape,gdtype", [
    ((256, 256), torch.float32), ((512, 768), torch.bfloat16),
    ((1280, 2560), torch.float32),
])
def test_adamw_speculative_kernel_equals_plain(cuda, shape, gdtype):
    """Versions that are fresh, stale, and 2^24 + 1 against rv = 2^24
    (fresh: it rounds to 2^24 in float32, as the Pallas kernel compares)."""
    rv = 1 << 24
    rng = np.random.default_rng(shape[1])
    grid = (shape[0] // 256, shape[1] // 256)
    versions_np = rng.choice(
        np.array([0, rv, rv + 1, rv + 3, 1 << 30], np.int64), grid)
    versions = torch.from_numpy(versions_np.astype(np.int32)).to(cuda)
    p, m, v, g = (t.reshape(shape) for t in _adamw_inputs(
        shape[0] * shape[1], gdtype, cuda, 2))
    hp = fused_adamw.hp_vector(5, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                               wd=0.01, rv=rv, device=cuda)
    fused_adamw.reset_launches()
    got = fused_adamw.fused_adamw_speculative(p, m, v, g, versions, hp)
    torch.cuda.synchronize()
    assert fused_adamw.LAUNCHES["fused_adamw_speculative"] == 1
    exp = ref.adamw_speculative_ref(p, m, v, g, versions, hp)
    assert _bits_equal(got[:3], exp[:3]) and torch.equal(got[3], exp[3])
    stale = versions_np.astype(np.float32) > np.float32(rv)
    np.testing.assert_array_equal(got[3].cpu().numpy(), stale)


def test_pot_train_step_on_card_twice_bitwise(cuda):
    """Two runs of three Pot steps (two microbatches) of the smoke
    configuration from one seed, under deterministic mode: losses and
    every leaf of the state bitwise equal, one kernel launch per
    parameter leaf per step."""
    cfg = get_smoke_config("stablelm-12b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    step = make_train_step(cfg, mode="pot", n_microbatches=2)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            fused_adamw.reset_launches()
            state = init_state(lm.init_params(
                torch.Generator(device=cuda).manual_seed(0), cfg,
                dtype=torch.float32))
            losses = []
            for i in range(3):
                state, loss = step(state, batch_at(dcfg, i, device=cuda))
                losses.append(loss)
            runs.append((state, torch.stack(losses),
                         fused_adamw.LAUNCHES["fused_adamw"]))
    finally:
        torch.use_deterministic_algorithms(was)
    (a, la, na), (b, lb, nb) = runs
    assert na == nb == 3 * len(leaves(a.params))
    assert torch.equal(la, lb) and torch.isfinite(la).all()
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert int(a.gv) == int(a.step) == 3


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-370m",
                                  "deepseek-moe-16b", "whisper-medium"])
def test_dp_step_of_other_kinds_on_card(cuda, arch):
    """The DP step's commit at one rank on the card for the other layer
    kinds (smoke configurations, AdamW): two runs of two steps from one
    seed bitwise equal, bitwise the pot step, and the fused AdamW kernel
    launched once per leaf per step (the per-head vectors, the conv and
    gate weights, the expert stacks, the encoder)."""
    cfg = get_smoke_config(arch)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)

    def batch(i):
        b = batch_at(dcfg, i, device=cuda)
        if cfg.encoder_layers:
            b["frames"] = torch.from_numpy(np.random.default_rng(i).normal(
                size=(4, cfg.n_frames, cfg.d_model)).astype(np.float32)
            ).to(cuda)
        return b

    kw = dict(n_microbatches=2, remat=False)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for step in (make_pot_dp_step(cfg, **kw), make_pot_dp_step(cfg, **kw),
                     make_train_step(cfg, mode="pot", **kw)):
            fused_adamw.reset_launches()
            state = init_state(lm.init_params(
                torch.Generator(device=cuda).manual_seed(0), cfg,
                dtype=torch.float32))
            losses = []
            for i in range(2):
                state, loss = step(state, batch(i))
                losses.append(loss)
            runs.append((state, torch.stack(losses),
                         fused_adamw.LAUNCHES["fused_adamw"]))
    finally:
        torch.use_deterministic_algorithms(was)
    a, la, na = runs[0]
    assert na == 2 * len(leaves(a.params))
    assert torch.isfinite(la).all() and int(a.gv) == 2
    for b, lb, nb in runs[1:]:
        assert nb == na and torch.equal(la, lb)
        assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_moe_dispatch_on_card_equals_cpu(cuda):
    """deepseek-moe-16b's dispatch at its full shape (8 x 1,024 tokens,
    top-6 of 64 experts, 49,152 assignments, capacity 960) under
    deterministic mode: drawn skewed, so that some experts pass their
    capacity and others stay under it; the sort, the positions, the
    kept mask, the dispatched rows and their gradient (a count of each
    token's kept assignments, exact) bitwise the CPU's, and nothing
    refused in deterministic mode."""
    from repro_torch.models import moe
    t, k, e, d = 8 * 1024, 6, 64, 2048
    cap = moe.capacity(t, k, e, 1.25)
    assert cap == 960
    gen = torch.Generator().manual_seed(31)
    gumbel = -torch.log(-torch.log(torch.rand(t, e, generator=gen)))
    flat_e = (gumbel - torch.log(torch.arange(1.0, e + 1))).topk(
        k, dim=-1).indices.reshape(-1)
    counts = torch.bincount(flat_e, minlength=e)
    assert (counts > cap).any() and (counts < cap).any()
    xt = torch.randn(t, d, generator=gen).bfloat16()

    def run(device):
        fe = flat_e.to(device)
        x = xt.to(device).requires_grad_(True)
        by_e = moe.sort_by_expert(fe, e)
        pos, keep = moe.dispatch_positions(fe, e, cap, by_e)
        x_e = moe.dispatch(x, fe, k, e, cap, by_e)
        x_e.backward(torch.ones_like(x_e))
        return [a.detach().cpu() for a in (*by_e, pos, keep, x_e, x.grad)]

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = run(cuda)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    exp = run("cpu")
    for a, b in zip(got, exp, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not exp[4].all() and exp[4].any()
