"""Parity of the port's fused AdamW (plain versions, on the CPU) with the
JAX reference: ``repro.kernels.ops.adamw_update`` (the Pallas kernel in
interpret mode), ``repro.kernels.ref`` and ``repro.optim.adamw``.

Inputs are made with numpy from a seed.  The port follows the Pallas
kernel's arithmetic: one float32 rounding per operation, with ``1 - b1``
and ``1 - b2`` the float32 differences of the float32 hyperparameters.
It is held to the reference tests' own tolerance, rtol = 3e-5 and
atol = 1e-7 (``tests/test_kernels.py``): ``ref.adamw_ref`` and
``optim.adamw`` take ``1 - b1`` from the Python float, and XLA's CPU
backend fuses ``b1 * m + (1 - b1) * g`` into one multiply-add in the
interpreted kernel, so neither is bitwise the kernel's float32 sequence.
Version checks and abort counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_optim
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import fused_adamw, ops, ref
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import leaves

TOL = dict(rtol=3e-5, atol=1e-7)


def _draw(rng, shape, gdtype):
    """p, m, v, g as numpy float32 (g rounded to bf16 where asked), and the
    jnp / torch g in its dtype."""
    p = rng.normal(size=shape).astype(np.float32)
    m = (rng.normal(size=shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    if gdtype == "bf16":
        return p, m, v, jnp.asarray(g, jnp.bfloat16), \
            torch.from_numpy(g).bfloat16()
    return p, m, v, jnp.asarray(g), torch.from_numpy(g)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, exp, **tol):
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("shape", [(256, 256), (3, 700), (1, 1), (512, 512),
                                   (1000,)])
@pytest.mark.parametrize("gdtype", ["f32", "bf16"])
def test_adamw_sweep_matches_reference(shape, gdtype):
    """The reference's own sweep: ``ops.adamw_update`` against the Pallas
    kernel (interpret mode) and ``ref.adamw_ref``."""
    rng = np.random.default_rng(sum(shape))
    p, m, v, jg, tg = _draw(rng, shape, gdtype)
    got = ops.adamw_update(*_t(p, m, v), tg, step=7, lr=3e-4, wd=0.1)
    assert all(t.shape == shape and t.dtype == torch.float32 for t in got)
    jargs = [jnp.asarray(a) for a in (p, m, v)]
    _close(got, ref_ops.adamw_update(*jargs, jg, step=7, lr=3e-4, wd=0.1))
    _close(got, ref_ref.adamw_ref(*jargs, jg, step=7, lr=3e-4, wd=0.1))


def test_adamw_no_nan_on_large_steps():
    p = torch.full((256, 256), 1e3)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    p2, m2, v2 = ops.adamw_update(p, m, v, torch.full_like(p, 1e3), step=1)
    assert torch.isfinite(p2).all() and torch.isfinite(v2).all()
    exp = ref_ops.adamw_update(jnp.full((256, 256), 1e3),
                               jnp.zeros((256, 256)), jnp.zeros((256, 256)),
                               jnp.full((256, 256), 1e3), step=1)
    _close((p2, m2, v2), exp)


@pytest.mark.parametrize("stale_frac", [0.0, 0.5, 1.0])
def test_speculative_matches_pallas_kernel(stale_frac):
    """Stale blocks keep p, m, v and abort; the abort map is exact."""
    rng = np.random.default_rng(int(stale_frac * 10))
    r, c = 512, 768
    p = rng.normal(size=(r, c)).astype(np.float32)
    m = (rng.normal(size=(r, c)) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=(r, c))) * 0.01).astype(np.float32)
    g = rng.normal(size=(r, c)).astype(np.float32)
    versions = ((rng.random((2, 3)) < stale_frac) * 10).astype(np.int32)
    got = ops.adamw_update_speculative(*_t(p, m, v, g, versions), 5, step=2)
    exp = ref_ops.adamw_update_speculative(
        *[jnp.asarray(a) for a in (p, m, v, g, versions)],
        jnp.asarray(5, jnp.int32), step=2)
    _close(got[:3], exp[:3])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(exp[3]))
    assert got[3].dtype == torch.int32
    assert int(got[3].sum()) == int((versions > 5).sum())
    stale = np.repeat(np.repeat(versions > 5, 256, 0), 256, 1)
    for new, old in zip(got[:3], (p, m, v)):   # stale blocks: bits kept
        np.testing.assert_array_equal(new.numpy()[stale], old[stale])
    if stale_frac == 0.0:
        _close(got[:3], ops.adamw_update(*_t(p, m, v, g), step=2), rtol=0,
               atol=0)


def test_versions_compare_as_float32_like_the_kernel():
    """Version 2^24 + 1 rounds to 2^24 in float32: against rv = 2^24 the
    Pallas kernel, and so the port, finds the block fresh and updates it,
    while ``ref.adamw_speculative_ref`` compares integers and aborts it.
    Version 2^24 + 3 rounds to 2^24 + 4 and is stale for all three."""
    rng = np.random.default_rng(7)
    p, m, v, g = (rng.normal(size=(256, 512)).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    versions = np.array([[(1 << 24) + 1, (1 << 24) + 3]], np.int32)
    rv = 1 << 24
    got = ops.adamw_update_speculative(*_t(p, m, v, g, versions), rv, step=1)
    jargs = [jnp.asarray(a) for a in (p, m, v, g, versions)]
    kernel = ref_ops.adamw_update_speculative(*jargs, rv, step=1)
    np.testing.assert_array_equal(got[3].numpy(), [[0, 1]])
    np.testing.assert_array_equal(np.asarray(kernel[3]), [[0, 1]])
    _close(got[:3], kernel[:3])
    assert not np.array_equal(got[0].numpy()[:, :256], p[:, :256])
    ints = ref_ref.adamw_speculative_ref(*jargs, rv, step=1)
    np.testing.assert_array_equal(np.asarray(ints[3]), [[1, 1]])


def test_hyperparameters_are_float32_like_the_kernel():
    """hp = [lr, b1, b2, eps, wd, bc1, bc2, rv] in float32; 1 - b1 is the
    float32 difference 1 - 0.9f = 0.100000024 (the Pallas kernel's), not
    float32(0.1) = 0.1 (``ref.adamw_ref``'s): from m = 0 and g = 1 the
    port's m' is the former, the reference's ref the latter."""
    hp = fused_adamw.hp_vector(torch.tensor(3, dtype=torch.int32), lr=1e-3,
                               b1=0.9, b2=0.999, eps=1e-8, wd=0.01, rv=5,
                               device="cpu")
    f = np.float32
    expect = [f(1e-3), f(0.9), f(0.999), f(1e-8), f(0.01),
              f(1) - f(0.9) ** f(3), f(1) - f(0.999) ** f(3), f(5)]
    np.testing.assert_allclose(hp.numpy()[0], expect, rtol=1e-7, atol=0)
    assert hp.shape == (1, 8) and hp.dtype == torch.float32
    ones = torch.ones((4,))
    _, m2, _ = ops.adamw_update(ones, torch.zeros(4), torch.zeros(4), ones,
                                step=1)
    assert m2[0].item() == float(f(1) - f(0.9)) == 0.10000002384185791
    _, ref_m, _ = ref_ref.adamw_ref(jnp.ones(4), jnp.zeros(4), jnp.zeros(4),
                                    jnp.ones(4), step=1)
    assert float(ref_m[0]) == float(f(0.1))


@pytest.mark.parametrize("steps", [1, 3])
def test_optimizer_over_a_parameter_tree_matches_reference(steps):
    """``optim.adamw_update`` over a smoke model's parameter tree against
    ``repro.optim.adamw_update`` (the jnp twin), step after step."""
    cfg = ref_smoke_config("stablelm-12b")
    params = ref_lm.init_params(jax.random.PRNGKey(0), cfg)
    pcfg = get_smoke_config("stablelm-12b")
    to_port = lambda tree: convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, tree), pcfg, device="cpu",
        dtype=torch.float32)
    rng = np.random.default_rng(steps)
    ref_state = ref_optim.adamw_init(params)
    state = adamw_init(to_port(params))
    tparams = to_port(params)
    for _ in range(steps):
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
            params)
        params, ref_state = ref_optim.adamw_update(params, grads, ref_state,
                                                   lr=1e-3, wd=0.1)
        tparams, state = adamw_update(tparams, to_port(grads), state,
                                      lr=1e-3, wd=0.1)
    assert state["step"].dtype == torch.int32
    assert int(state["step"]) == int(ref_state["step"]) == steps
    for got, exp in ((tparams, params), (state["m"], ref_state["m"]),
                     (state["v"], ref_state["v"])):
        exp = leaves(to_port(exp))
        assert len(leaves(got)) == len(exp)
        for a, b in zip(leaves(got), exp):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_argument_checks():
    p = torch.zeros((256, 256))
    with pytest.raises(ValueError, match="m must be float32"):
        ops.adamw_update(p, torch.zeros((256, 255)), p, p, step=1)
    with pytest.raises(ValueError, match="g must be float32 or bfloat16"):
        ops.adamw_update(p, p, p, p.half(), step=1)
    with pytest.raises(ValueError, match="p must be float32"):
        ops.adamw_update(p.double(), p, p, p, step=1)
    with pytest.raises(ValueError, match="multiples of 256"):
        ops.adamw_update_speculative(p[:128], p[:128], p[:128], p[:128],
                                     torch.zeros((1, 1), dtype=torch.int32),
                                     0, step=1)
    with pytest.raises(ValueError, match="versions must be"):
        ops.adamw_update_speculative(p, p, p, p,
                                     torch.zeros((1, 2), dtype=torch.int32),
                                     0, step=1)
    with pytest.raises(ValueError, match="no fused_adamw kernel"):
        ops.adamw_update(*(p.to("meta") for _ in range(4)), step=1)


def test_empty_leaf_and_inputs_untouched():
    e = torch.zeros((0, 5))
    assert all(t.shape == (0, 5) for t in ops.adamw_update(e, e, e, e,
                                                           step=1))
    rng = np.random.default_rng(3)
    p, m, v, _, g = _draw(rng, (7, 9), "f32")
    args = _t(p, m, v) + [g]
    before = [a.clone() for a in args]
    ops.adamw_update(*args, step=2)
    assert all(torch.equal(a, b) for a, b in zip(args, before))
