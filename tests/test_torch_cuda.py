"""The hand-written CUDA kernels against their plain versions, on the
card: bitwise equality on ragged and main-path shapes, launch counting,
and a small stream through the card's matrix formulation equal to the
CPU's scatter-min run.  Marked ``cuda``; each test skips where
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
from repro_torch.kernels import conflict, ref

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
