"""The serving step's in-place commit: ``Session.step`` commits each
step's rows into its own ``page_meta`` and ``page_versions`` through
``ops.kv_cache_commit_`` (no copy of the store), with tokens and
``fingerprint()`` bitwise the JAX reference session's, and the in-place
commit equal to the functional one on the hazard draws of
tests/test_torch_kv_commit.py.

As in tests/test_torch_serve.py, the port's session is fed the
reference session's logits each step: bf16 logits tie often enough that
two implementations of the model math may pick different tokens, and
the point here is the commit.
"""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.serve.session import Session as RefSession
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.serve.session import Session

N_SLOTS, MAX_SEQ = 4, 32


def _sessions():
    """The reference session over stablelm-smoke's weights, recording its
    logits, and the port's session fed them."""
    cfg = ref_smoke_config("stablelm-12b")
    ref = RefSession(cfg, ref_lm.init_params(jax.random.PRNGKey(0), cfg),
                     n_slots=N_SLOTS, max_seq=MAX_SEQ)
    logits = []
    ref_decode = ref._decode

    def recording(*args):
        out = ref_decode(*args)
        logits.append(np.asarray(out[0], np.float32))
        return out

    ref._decode = recording
    port = Session(get_smoke_config("stablelm-12b"), params={},
                   n_slots=N_SLOTS, max_seq=MAX_SEQ, device="cpu")
    port._decode = lambda p, cache, t, pos: (
        torch.from_numpy(logits[-1]).bfloat16(), cache)
    for s in range(N_SLOTS):
        ref.add_request(s, 3 + 7 * s)
        port.add_request(s, 3 + 7 * s)
    return ref, port


def test_step_commits_into_the_session_store_in_place():
    ref, port = _sessions()
    meta, versions = port.page_meta, port.page_versions
    ptrs = (meta.data_ptr(), versions.data_ptr())
    for _ in range(8):
        ref.step()                               # records the logits
        port.step()
    assert port.page_meta is meta and port.page_versions is versions
    assert (meta.data_ptr(), versions.data_ptr()) == ptrs
    assert versions.count_nonzero() == N_SLOTS   # one page a slot so far
    assert meta.any()


@pytest.mark.parametrize("n_steps", [8, 40])   # 40: past max_seq
def test_in_place_session_matches_reference_bitwise(n_steps):
    """Tokens, the store and ``fingerprint()`` bitwise the reference's;
    past ``max_seq`` a slot's pages run into the next slot's range and
    past the last page they are dropped, as the reference drops them."""
    ref, port = _sessions()
    for _ in range(n_steps):
        ref_tokens = np.asarray(ref.step())    # records the logits
        np.testing.assert_array_equal(port.step(), ref_tokens)
    np.testing.assert_array_equal(port.page_meta.numpy(),
                                  np.asarray(ref.page_meta))
    np.testing.assert_array_equal(port.page_versions.numpy(),
                                  np.asarray(ref.page_versions))
    assert port.fingerprint() == ref.fingerprint()


def _hazard_draw(seed, dtype):
    """The draw of test_kv_commit_hazards_match_pallas: repeated pages
    and (page, row) pairs, arbitrary sequence numbers, skipped slots, row
    ids outside the page and page ids past either end."""
    rng = np.random.default_rng(100 + seed)
    p, page, h, s = 6, 4, 16, 24
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    cache = torch.from_numpy(
        rng.normal(size=(p, page, h)).astype(np.float32)).to(dtype)
    versions = i32(rng.integers(0, 5, (p,)))
    rows = torch.from_numpy((rng.normal(size=(s, h)) * 1e3).astype(
        np.float32))
    meta = [i32(rng.integers(-3, p + 3, (s,))),
            i32(rng.integers(-6, page + 6, (s,))),
            i32(rng.permutation(s) + 50), i32(rng.random(s) < 0.7)]
    return cache, versions, rows, meta


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_commit_equals_functional_on_hazards(seed, dtype):
    cache, versions, rows, meta = _hazard_draw(seed, dtype)
    exp_c, exp_v = ops.kv_cache_commit(cache, versions, rows, *meta)
    assert exp_c is not cache and exp_v is not versions
    got_c, got_v = ops.kv_cache_commit_(cache, versions, rows, *meta)
    assert got_c is cache and got_v is versions
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got_c.view(bits), exp_c.view(bits))
    assert torch.equal(got_v, exp_v)
