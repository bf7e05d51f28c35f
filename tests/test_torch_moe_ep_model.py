"""The port's whole model through expert parallelism on 8 gloo ranks of
a (2, 4) mesh against the reference's ``_moe_shardmap`` path on 8 host
devices (``tests/_torch_moe_ep.py``), in float32, deepseek-smoke and
arctic-smoke at their capacity factor and at 1.0: ``lm.forward``'s
logits (4 x 32 tokens, the sequence split over the model axis) and one
``decode_step``'s (S = 1: the tokens replicated over the model axis),
each MoE call's routing identical per block and the logits within 1e-4
in relative L2; ``lm.prefill``'s last logits against the reference's
forward; every rank's results, and its ``Session`` (prefill and 4
greedy steps), bitwise the same."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_moe_ep as ep


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ep.run_both(tmp_path_factory.mktemp("moe_ep_model"), ("model",))


@pytest.mark.parametrize("cf", ep.CFS)
@pytest.mark.parametrize("arch", ep.ARCHS)
def test_forward_matches_reference_schedule(runs, arch, cf):
    ref_result, ranks = runs
    exp = ref_result[(arch, cf)]["model"]
    for got in ranks:
        model = got[(arch, cf)]["model"]
        ep.check_routing(exp["forward_routing"], model["forward_routing"],
                         got["coord"])
        assert ep.rel(model["logits"], exp["logits"]) <= ep.F32_REL
        assert ep.rel(model["prefill"][:, 0],
                      exp["logits"][:, -1]) <= ep.F32_REL
        for key in ("logits", "prefill"):
            assert ep.same_bits(model[key], ranks[0][(arch, cf)]["model"][key])


@pytest.mark.parametrize("cf", ep.CFS)
@pytest.mark.parametrize("arch", ep.ARCHS)
def test_decode_step_matches_reference_schedule(runs, arch, cf):
    ref_result, ranks = runs
    exp = ref_result[(arch, cf)]["model"]
    for got in ranks:
        model = got[(arch, cf)]["model"]
        ep.check_routing(exp["decode_routing"], model["decode_routing"],
                         got["coord"])
        assert ep.rel(model["decode"], exp["decode"]) <= ep.F32_REL
        assert ep.same_bits(model["decode"],
                            ranks[0][(arch, cf)]["model"]["decode"])


@pytest.mark.parametrize("cf", ep.CFS)
@pytest.mark.parametrize("arch", ep.ARCHS)
def test_session_is_the_same_on_every_rank(runs, arch, cf):
    _, ranks = runs
    first = ranks[0][(arch, cf)]["model"]
    assert first["session"].shape == (ep.B, 5)
    for got in ranks[1:]:
        model = got[(arch, cf)]["model"]
        assert ep.same_bits(model["session"], first["session"])
        assert model["fingerprint"] == first["fingerprint"]


def test_session_prefill_is_greedy_decoding(monkeypatch):
    """``Session.prefill`` then 4 steps (float32 deepseek-smoke, no
    profile, no expert over capacity) emit the greedy tokens of
    ``lm.forward`` over the prompt grown by each emitted token."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import blocks, lm, moe
    from repro_torch.serve.session import Session
    for m in (blocks, lm, moe):
        monkeypatch.setattr(m, "C", torch.float32)
    cfg = get_smoke_config("deepseek-moe-16b")
    params = lm.init_params(torch.Generator().manual_seed(5), cfg,
                            dtype=torch.float32)
    prompts = torch.randint(0, cfg.vocab, (3, 9),
                            generator=torch.Generator().manual_seed(6))
    sess = Session(cfg, params, n_slots=3, max_seq=32, device="cpu")
    with torch.no_grad():
        got = [torch.from_numpy(sess.prefill(prompts)).long()]
        got += [torch.from_numpy(t).long() for t in sess.generate(4).T]
        seq = prompts
        for tok in got:
            want = lm.forward(params, seq, cfg)[:, -1].argmax(-1)
            assert torch.equal(tok, want)
            seq = torch.cat([seq, want[:, None]], dim=1)
    assert (sess.pos == 9 + 4).all() and sess.active.all()
    with pytest.raises(ValueError, match="some already hold requests"):
        sess.prefill(prompts)
