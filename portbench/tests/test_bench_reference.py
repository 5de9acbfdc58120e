"""The plain reference against the port at a tiny size on the CPU, in
float32 (so the two agree to rounding)."""

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.drivers import serve, train
from portbench.reference import frontend
from portbench.reference import model as ref
from portbench.weights import make_params

from .conftest import tiny_config, tiny_context, tiny_mix


def _port(cfg):
    from speech_tranformer_pytorch_tpu_torch.config import config_from_dict

    return config_from_dict(cfg)


def _batch(entry="train", seed=4):
    return traffic.build_pool(tiny_mix(entry), tiny_config(), seed, train=entry == "train")[0]


def test_fbank_matches_the_port():
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features

    hb = _batch()
    cfg = tiny_config()
    want, wl = extract_features(hb.audio, hb.sample_lens, _port(cfg).features, device="cpu")
    got, gl = frontend.fbank(torch.from_numpy(hb.audio), torch.from_numpy(hb.sample_lens),
                             cfg["features"])
    assert torch.equal(wl.long(), gl)
    assert torch.allclose(got, want.float(), atol=2e-4, rtol=1e-4)


def test_forward_matches_the_port_without_dropout():
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer

    cfg = tiny_config()
    m = cfg["model"]
    p = make_params(m, 9, "cpu")
    net = SpeechTransformer(_port(cfg).model)
    net.load_state_dict(p)
    hb = _batch()
    feats, lens = frontend.fbank(torch.from_numpy(hb.audio), torch.from_numpy(hb.sample_lens),
                                 cfg["features"])
    tin = torch.from_numpy(hb.targets_in).long()
    tl = torch.from_numpy(hb.target_lens).long()
    with torch.no_grad():
        want = net(feats, lens.int(), tin, tl.int())
    mem, ml = ref.encode(p, m, feats, lens)
    got = ref.decode(p, m, tin, tl, mem, ml)
    valid = torch.arange(tin.shape[1])[None] < tl[:, None]
    assert torch.allclose(got[valid], want[valid], atol=1e-4, rtol=1e-4)


def test_parameter_names_are_the_ports():
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer

    from portbench.harness import load_json

    cfg = load_json("configs", "base.json")["config"]
    want = {k: tuple(v.shape) for k, v in SpeechTransformer(_port(cfg).model).state_dict().items()}
    assert {n: s for n, s, _ in ref.param_spec(cfg["model"])} == want


def test_weights_are_the_seeds():
    a, b = make_params(tiny_config()["model"], 2 ** 31 + 5, "cpu"), make_params(
        tiny_config()["model"], 2 ** 31 + 5, "cpu")
    c = make_params(tiny_config()["model"], 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.embed.weight"], c["decoder.embed.weight"])
    w = a["encoder.layers.0.ffn.fc1.weight"]
    assert float(w.std()) == pytest.approx(1 / np.sqrt(w.shape[1]), rel=0.1)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_served_scores_and_prune_match_to_rounding(seed):
    """In float32 the port's scores are the reference's, and no extension
    its prune dropped outscores one it kept."""
    r = serve.run(tiny_context("serve", seconds=0.3, seed=seed))
    n = r.numbers
    assert r.failed == 0 and n["score_gap_mean"] < 1e-5
    assert n["prune_gap_mean"] < 1e-5


def test_prune_gap_is_the_margin_of_a_dropped_extension():
    from portbench.reference.serve import prune_gaps

    # One utterance, beam 2, 2 steps, 6 tokens (0-2 special): log p of
    # the first token 3, 4, 5 is -1, -2, -0.5, of the second -1, -1.5, -3.
    lp = np.full((1, 2, 3, 6), -9.0)
    lp[0, :, 0, 3:] = [-1.0, -2.0, -0.5]
    lp[0, 0, 1, 3:] = [-1.0, -1.5, -3.0]     # after token 3
    lp[0, 1, 1, 3:] = [-1.0, -1.5, -3.0]
    tokens = np.array([[[3, 3], [3, 4]]])
    # step 0: the two lanes share the prefix (3): not all lanes known.
    # step 1: lanes 3 3 (-2) and 3 4 (-2.5); parent (3) dropped 3 5 (-4).
    assert prune_gaps(lp, tokens, np.array([[2, 2]])) == [pytest.approx(-1.5)]
    # served 3 3 and 4 3 instead: step 0 lanes 3 (-1) and 4 (-2), token 5
    # (-0.5) was dropped: a margin of 1.5 over the worst kept.
    tokens = np.array([[[3, 3], [4, 3]]])
    assert prune_gaps(lp, tokens, np.array([[2, 2]]))[0] == pytest.approx(1.5)


def test_train_steps_match_to_rounding():
    """Dropout bits and SpecAugment masks are the ones the seed gives: the
    losses agree to float32 rounding (the moments are stored in bf16, so
    the gradient read back from them and the change carry its rounding)."""
    r = train.run(tiny_context("train", seconds=0.3))
    n = r.numbers
    assert r.failed == 0
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 5e-3 and n["change_gap"] < 3e-2


def test_dropout_bits_follow_the_ports_draws():
    from speech_tranformer_pytorch_tpu_torch.ops.dropout import dropout_quantized, step_generator

    x = torch.ones(3, 5, 7)
    want = dropout_quantized(x, 0.1, step_generator(11, 2, "cpu"))
    bits = ref.draw_dropout_bits(ref.step_generator(11, 2, "cpu"), [(3, 5, 7)])
    got = ref.Dropout(0.1, bits)(x)
    assert torch.allclose(got, want)
