"""Router ties in the whole-model parity tests of the MoE architectures.

Both packages route each token to the top-k of its router softmax, from
bf16 activations that they round at different places.  Where the
reference's k-th and (k+1)-th probabilities (nearly) tie, the two may
pick different experts; the token then takes another expert's output,
and capacity can drop other tokens of its row.  That is bf16 rounding,
not a fault: :func:`record_routing` records both packages' routing, and
:func:`rows_routed_alike` checks that every differing choice is such a
tie and returns the batch rows whose every token was routed alike in
every MoE call, the rows whose logits the tests compare.  The routing
itself is held bitwise on equal inputs in tests/test_torch_layers.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.moe as ref_moe
from repro_torch.models import moe


@contextlib.contextmanager
def record_routing():
    """Within the block, every reference ``_route_and_dispatch`` call
    (unjitted) and every port MoE call appends (expert indices (T, k),
    kept mask (T, k), router probabilities (T, E)) to ``rec["ref"]`` /
    ``rec["port"]``."""
    rec = {"ref": [], "port": []}
    ref_rd, port_route, port_pos = (ref_moe._route_and_dispatch, moe.route,
                                    moe.dispatch_positions)
    pending = {}

    def ref_recording(xt, router, e, k, cf):
        out = ref_rd(xt, router, e, k, cf)
        probs = jax.nn.softmax(
            (xt @ router.astype(xt.dtype)).astype(jnp.float32), axis=-1)
        t = xt.shape[0]
        rec["ref"].append((np.asarray(out[1]).reshape(t, k),
                           np.asarray(out[3]).reshape(t, k),
                           np.asarray(probs)))
        return out

    def port_routing(xt, router, k):
        gate, eidx = port_route(xt, router, k)
        pending.update(eidx=eidx.numpy(), probs=torch.softmax(
            (xt @ router.to(xt.dtype)).float(), dim=-1).numpy())
        return gate, eidx

    def port_positions(flat_e, e, cap, *by_e):
        pos, keep = port_pos(flat_e, e, cap, *by_e)
        eidx = pending["eidx"]
        rec["port"].append((eidx, keep.numpy().reshape(eidx.shape),
                            pending["probs"]))
        return pos, keep

    ref_moe._route_and_dispatch = ref_recording
    moe.route, moe.dispatch_positions = port_routing, port_positions
    try:
        yield rec
    finally:
        ref_moe._route_and_dispatch = ref_rd
        moe.route, moe.dispatch_positions = port_route, port_pos


def rows_routed_alike(rec, batch: int) -> np.ndarray:
    """(batch,) bool: the rows whose tokens both packages routed and kept
    alike in every MoE call.  Asserts that each token routed apart had a
    tie: at each of its top-k places where the packages chose two
    experts, the reference's probabilities of the two no further apart
    than twice the packages' largest disagreement on that token's
    probabilities."""
    assert len(rec["ref"]) == len(rec["port"])
    alike = np.ones(batch, bool)
    for (re, rk, rp), (pe, pk, pp) in zip(rec["ref"], rec["port"]):
        t = re.shape[0]
        for tok, j in zip(*np.nonzero(re != pe)):
            slack = np.abs(rp[tok] - pp[tok]).max()
            a, b = rp[tok, re[tok, j]], rp[tok, pe[tok, j]]
            assert abs(a - b) <= 2 * slack, (
                f"token {tok} routed apart without a tie: experts "
                f"{re[tok, j]} and {pe[tok, j]} at {a} and {b}, the "
                f"packages differ by {slack}")
        apart = ((re != pe) | (rk != pk)).any(1)
        alike &= ~apart.reshape(batch, t // batch).any(1)
    return alike
