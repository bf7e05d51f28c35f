"""The hand-written CUDA kernels against their plain versions, on the
card: bitwise equality on ragged and main-path shapes, launch counting,
a small stream through the card's matrix formulation equal to the CPU's
scatter-min run, and the serving session on the card against the CPU's.  Marked ``cuda``; each test skips where
``torch.cuda.is_available()`` is false (decided inside the fixture, not
at import).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import convert
from repro_torch.core import workloads as W
from repro_torch.core.engine import TRACE_FIELDS
from repro_torch.core.session import PotSession
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import conflict, kv_commit, ref
from repro_torch.models import lm
from repro_torch.serve.session import Session

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
])
def test_pair_kernel_equals_plain(cuda, m, n, w, density):
    rng = np.random.default_rng(m + n + w)
    a, b = _bits(rng, m, w, density, cuda), _bits(rng, n, w, density, cuda)
    conflict.reset_launches()
    out = conflict.conflict_matrix_bits_pair(a, b)
    torch.cuda.synchronize()
    assert conflict.LAUNCHES["conflict_matrix_bits_pair"] == 1
    assert torch.equal(out, ref.conflict_matrix_bits_pair_ref(a, b))


@pytest.mark.parametrize("k,w,live_frac", [
    (1, 1, 1.0), (64, 32, 0.0), (100, 70, 0.3), (257, 300, 0.02),
    (1024, 2048, 0.5),
])
def test_delta_kernel_equals_plain(cuda, k, w, live_frac):
    rng = np.random.default_rng(k + w)
    a = _bits(rng, k, w, 0.01, cuda)
    b = _bits(rng, k, w, 0.005, cuda)
    old = torch.from_numpy(rng.random((k, k)) < 0.5).to(cuda)
    live = torch.from_numpy(rng.random(k) < live_frac).to(cuda)
    conflict.reset_launches()
    out = conflict.conflict_matrix_bits_delta(a, b, old, live)
    torch.cuda.synchronize()
    assert conflict.LAUNCHES["conflict_matrix_bits_delta"] == 1
    assert torch.equal(out, ref.conflict_matrix_bits_delta_ref(a, b, old,
                                                               live))


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
    for _ in range(8):
        cpu_tokens = cpu.step()          # records the logits card is fed
        np.testing.assert_array_equal(card.step(), cpu_tokens)
    assert kv_commit.LAUNCHES["kv_commit"] == 8
    assert torch.equal(card.page_meta.cpu(), cpu.page_meta)
    assert torch.equal(card.page_versions.cpu(), cpu.page_versions)
    assert card.fingerprint() == cpu.fingerprint()
