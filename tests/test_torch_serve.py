"""Parity of the port's serving session with the JAX reference's
(``repro.serve.session``) and the port's own replica property.

The Pot half — sequencer, ordered paged commit, fingerprint — is held
bitwise: the port's ``Session`` is given the reference session's logits
each step (bf16 logits tie often enough that two implementations of the
model math may pick different tokens), and must then emit the same
tokens and commit the same ``page_meta`` / ``page_versions`` with the
same ``fingerprint()``.  The model math itself is held to a tolerance
in tests/test_torch_models.py.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.serve.session import Session as RefSession
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.serve.session import Session

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _drive(sess, schedule, n_steps):
    """Add requests as ``schedule`` says ({step: [(slot, token), ...]})
    and step ``n_steps`` times; returns the (steps, slots) tokens."""
    out = []
    for i in range(n_steps):
        for slot, tok in schedule.get(i, []):
            sess.add_request(slot, tok)
        out.append(np.asarray(sess.step()))
    return np.stack(out)


@pytest.mark.parametrize("n_slots,max_seq,page_size,n_steps,schedule", [
    # the launcher's shape: every slot active from the start
    (4, 128, 16, 16, {0: [(s, 3 + 7 * s) for s in range(4)]}),
    # slots joining late, one never active; positions run past max_seq,
    # so pages spill into the next slot's range and past the last page
    (3, 16, 4, 20, {0: [(2, 5)], 3: [(0, 11)]}),
])
def test_session_with_reference_logits_matches_bitwise(
        n_slots, max_seq, page_size, n_steps, schedule):
    cfg = ref_smoke_config("stablelm-12b")
    params = ref_lm.init_params(jax.random.PRNGKey(0), cfg)
    ref = RefSession(cfg, params, n_slots=n_slots, max_seq=max_seq,
                     page_size=page_size)
    logits = []
    ref_decode = ref._decode

    def recording(*args):
        out = ref_decode(*args)
        logits.append(np.asarray(out[0], np.float32))
        return out

    ref._decode = recording
    ref_tokens = _drive(ref, schedule, n_steps)

    port = Session(get_smoke_config("stablelm-12b"), params={},
                   n_slots=n_slots, max_seq=max_seq, page_size=page_size,
                   device="cpu")
    fed = iter(logits)
    port._decode = lambda p, cache, t, po: (
        torch.from_numpy(next(fed)).bfloat16(), cache)
    port_tokens = _drive(port, schedule, n_steps)

    np.testing.assert_array_equal(port_tokens, ref_tokens)
    np.testing.assert_array_equal(port.page_meta.numpy(),
                                  np.asarray(ref.page_meta))
    np.testing.assert_array_equal(port.page_versions.numpy(),
                                  np.asarray(ref.page_versions))
    np.testing.assert_array_equal(port.pos, np.asarray(ref.pos))
    assert port.fingerprint() == ref.fingerprint()
    assert np.asarray(ref.page_versions).any()


def test_session_with_reference_weights_runs_the_same_commits():
    """The port's own decode over the reference's weights: the logits
    agree within tolerance, and feeding the port's argmax to both keeps
    the committed state bitwise equal."""
    cfg = ref_smoke_config("qwen15_32b")
    params = ref_lm.init_params(jax.random.PRNGKey(3), cfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                           get_smoke_config("qwen15_32b"),
                                           device="cpu")
    ref = RefSession(cfg, params, n_slots=2, max_seq=32)
    port = Session(get_smoke_config("qwen15_32b"), tparams, n_slots=2,
                   max_seq=32, device="cpu")
    port_decode, ref_decode = port._decode, ref._decode
    fed = []

    def port_recording(*args):
        out = port_decode(*args)
        fed.append(out[0].float().numpy())
        return out

    def ref_fed(*args):
        logits, cache = ref_decode(*args)
        np.testing.assert_allclose(np.asarray(logits, np.float32), fed[-1],
                                   rtol=3e-2, atol=3e-2)
        return jax.numpy.asarray(fed[-1], jax.numpy.bfloat16), cache

    port._decode, ref._decode = port_recording, ref_fed
    for s in (0, 1):
        port.add_request(s, 3 + 7 * s)
        ref.add_request(s, 3 + 7 * s)
    for _ in range(6):
        np.testing.assert_array_equal(port.step(), np.asarray(ref.step()))
    assert port.fingerprint() == ref.fingerprint()


def test_replicas_with_reversed_arrivals_are_identical():
    cfg = get_smoke_config("starcoder2-15b")
    params = lm.init_params(torch.Generator().manual_seed(5), cfg)
    requests = [(s, 3 + 7 * s) for s in range(3)]
    runs = []
    for order in (requests, requests[::-1]):
        sess = Session(cfg, params, n_slots=3, max_seq=32, device="cpu")
        for slot, tok in order:
            sess.add_request(slot, tok)
        runs.append((sess.generate(8), sess.fingerprint()))
    (t1, f1), (t2, f2) = runs
    np.testing.assert_array_equal(t1, t2)
    assert f1 == f2


def test_session_refuses_a_second_request_on_a_busy_slot():
    sess = Session(get_smoke_config("stablelm-12b"), params={}, n_slots=2,
                   max_seq=16, device="cpu")
    sess.add_request(1, 4)
    with pytest.raises(ValueError):
        sess.add_request(1, 5)


def test_launcher_replica_check_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-12b", "--device", "cpu", "--replica-check"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "replica (reversed arrivals) identical: True" in out.stdout
    assert "fingerprint=0x" in out.stdout
