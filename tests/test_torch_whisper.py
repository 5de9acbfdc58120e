"""OpenAI's Whisper in the port (the ``whisper_large_v3`` preset's
port-only fields: ``features.kind='whisper'``, the Conv1d stem, Whisper's
position tables, GELU, LayerNorm's epsilon, a forced prompt and suppressed
ids) on the CPU at a tiny Whisper-shaped size: d 32, 4 heads, 2 + 2
layers, 16 mel bins, Whisper's own 30-s window (3,000 frames, 1,500
encoder frames), a vocabulary of 40, seeded weights with drawn biases
(the key biases too, which the reference, like Whisper, has none of).

The port is held to the benchmark's reference (``portbench/reference/
whisper.py``, written from ``whisper/audio.py``, ``model.py`` and
``decoding.py``) in float32: the log-mel (and to a direct ``torch.stft``
transcription of ``audio.py``), the DFT kernel's folded matrices, the
encoder, the teacher-forced logits after the prompt, the prompt's forced
steps followed by step decoding against the whole forward, the suppression, the
beam search's tokens, lengths and scores against the reference's own
search, and the served scores against the reference's judge. Every path
Whisper lacks refuses it, and the five JAX presets keep their dictionary
and hashes."""

import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.nn import functional as F  # noqa: E402

from portbench.reference import whisper as ref  # noqa: E402
from speech_tranformer_pytorch_tpu import config as jcfg  # noqa: E402
from speech_tranformer_pytorch_tpu_torch import config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.features import (  # noqa: E402
    extract_features, slaney_mel_matrix)
from speech_tranformer_pytorch_tpu_torch.decoding import beam, beam_graph  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import interface, stft_mel  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402

BEAM, STEPS = 3, 6
PROMPT, SUPPRESS, FIRST = (1, 5, 6, 7), (0, 1, 8, 9, 10, 11), (2, 12)
SMALL = {"model.d_model": 32, "model.num_heads": 4, "model.d_ff": 64,
         "model.num_encoder_layers": 2, "model.num_decoder_layers": 2, "model.vocab_size": 40,
         "model.input_dim": 16, "model.max_source_positions": 1500,
         "model.max_target_positions": 32, "model.dtype": "float32",
         "features.num_mel_bins": 16, "features.output_dtype": "float32", "data.max_target_len": 32,
         "decode.prompt": PROMPT, "decode.suppress": SUPPRESS, "decode.suppress_first": FIRST}


def _config(**over):
    return config.get_config("whisper_large_v3", **{**SMALL, **over}).validate()


def _params(cfg, seed: int = 0):
    """Seeded weights with every bias drawn (normal, std 0.1), the key
    biases included (a key bias moves no attention, so the reference, which
    has none, must not see it), LayerNorm scales and
    shifts drawn, <eos>'s tied row zero (it never wins a search)."""
    g = torch.Generator().manual_seed(seed)
    model = SpeechTransformer(cfg.model).init_weights(g)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith(".bias"):
                t.normal_(0.0, 0.1, generator=g)
            elif "ln" in name or "norm" in name:
                t.add_(torch.randn(t.shape, generator=g) * 0.1)
        model.decoder.embed.weight[2].zero_()
    return model.state_dict()


def _model(cfg, params):
    model = SpeechTransformer(cfg.model)
    model.load_state_dict(params)
    return model.eval()


def _audio(lens=(490000, 210000, 70000), seed: int = 1):
    """int16 PCM [B, S]: the first row longer than the 30-s window (it is
    trimmed), the others shorter (padded), noise past each length."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(len(lens), max(lens), generator=g) * 3000.0
    t = torch.arange(max(lens)) / 16000.0
    x += 6000.0 * torch.sin(2 * math.pi * 220.0 * t)
    return x.clamp(-32768, 32767).to(torch.int16), torch.tensor(lens)


def _audio_py(audio: torch.Tensor, n: int, filters: torch.Tensor) -> torch.Tensor:
    """``whisper/audio.py``'s ``log_mel_spectrogram`` of one trimmed or
    padded float waveform, transcribed (``torch.stft``, centred, reflect)."""
    audio = audio[:n] if audio.shape[0] >= n else F.pad(audio, (0, n - audio.shape[0]))
    stft = torch.stft(audio, 400, 160, window=torch.hann_window(400), return_complex=True)
    magnitudes = stft[..., :-1].abs() ** 2
    log_spec = torch.clamp(filters @ magnitudes, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).t()


def test_log_mel_matches_the_reference_and_audio_py():
    cfg = _config()
    audio, lens = _audio()
    feats, frame_lens = extract_features(audio, lens, cfg.features, device="cpu")
    assert feats.shape == (3, 3000, 16) and frame_lens.tolist() == [3000] * 3
    want = ref.log_mel(audio, lens, cfg.to_dict()["features"])
    torch.testing.assert_close(feats, want, atol=2e-5, rtol=0)
    filters = torch.from_numpy(ref.mel_filters(cfg.to_dict()["features"]))
    np.testing.assert_allclose(slaney_mel_matrix(16, 400, 16000), filters.numpy().T,
                               rtol=1e-5, atol=1e-9)
    for row in range(3):
        wave = audio[row].float() / 32768.0 * (torch.arange(audio.shape[1]) < lens[row])
        torch.testing.assert_close(feats[row], _audio_py(wave, 480000, filters),
                                   atol=2e-5, rtol=0)


def test_dft_kernel_matrices_compute_whispers_mel_power():
    # The card's DFT kernel computes frames @ C_eff and frames @ S_eff, their
    # squares' sum, then the mel product; its folded matrices must hold the
    # periodic window and no DC removal or pre-emphasis. The kernel reads
    # each matrix as a flat row-major buffer, so they are read so here.
    cfg = _config()
    assert stft_mel.kernel_for(cfg.features) == "dft" and not stft_mel.natural_log(cfg.features)
    c_eff, s_eff, mel = (torch.from_numpy(np.frombuffer(m.tobytes(order="A"), np.float32)
                                          .reshape(m.shape)).double()
                         for m in stft_mel._effective_matrices(cfg.features))
    x = torch.randn(2, 400 + 160 * 9, generator=torch.Generator().manual_seed(3))
    frames = x.unfold(-1, 400, 160).double()
    emulated = ((frames @ c_eff) ** 2 + (frames @ s_eff) ** 2) @ mel
    plain = stft_mel.log_mel_reference(x, cfg.features, 10).double()
    torch.testing.assert_close(emulated, plain, rtol=1e-4, atol=1e-9)


def test_encoder_matches_the_reference():
    cfg = _config()
    params = _params(cfg)
    model = _model(cfg, params)
    audio, lens = _audio()
    feats, frame_lens = extract_features(audio, lens, cfg.features, device="cpu")
    memory, mem_lens = model.encode(feats, frame_lens)
    assert mem_lens.tolist() == [1500] * 3
    want = ref.encode(params, cfg.to_dict()["model"], feats)
    torch.testing.assert_close(memory, want, atol=2e-4, rtol=1e-4)


def _memory(cfg, params):
    audio, lens = _audio()
    feats, frame_lens = extract_features(audio, lens, cfg.features, device="cpu")
    return _model(cfg, params).encode(feats, frame_lens)


def test_teacher_forced_logits_with_the_prompt_match_the_reference():
    cfg = _config()
    params = _params(cfg)
    model = _model(cfg, params)
    memory, mem_lens = _memory(cfg, params)
    g = torch.Generator().manual_seed(5)
    toks = torch.cat([torch.tensor(PROMPT).expand(3, -1),
                      torch.randint(13, 40, (3, 7), generator=g)], 1)
    with torch.no_grad():
        got = model.decoder(toks, torch.full((3,), toks.shape[1]), memory, mem_lens)
    m = cfg.to_dict()["model"]
    want = ref.decode(params, m, toks, ref.cross_kv(params, m, memory), 1)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


def test_prompt_prefill_then_steps_equal_the_whole_forward():
    cfg = _config()
    params = _params(cfg)
    model = _model(cfg, params)
    memory, mem_lens = _memory(cfg, params)
    toks = torch.tensor([[9, 30, 17, 22], [13, 13, 39, 4], [25, 6, 33, 19]])
    seq = torch.cat([torch.tensor(PROMPT).expand(3, -1), toks], 1)
    off, steps = len(PROMPT) - 1, toks.shape[1] + 1
    interface.reset_row_write_counts()
    with torch.no_grad():
        whole = model.decoder(seq, torch.full((3,), seq.shape[1]), memory, mem_lens)
        cache = model.init_cache(memory, off + steps, 1)
        lineage = torch.zeros((3, 1, off + steps), dtype=torch.int32)
        beam.read_prompt(model, beam.Prompt(PROMPT), cache, mem_lens, lineage)
        assert interface.row_write_counts()["index_copy"] == 2 * off
        for i in range(steps):
            pos = off + i
            logits, cache = model.decode_step(seq[:, pos].int(), torch.tensor(pos, dtype=torch.int32),
                                              cache, mem_lens, 1, lineage)
            torch.testing.assert_close(logits, whole[:, pos], atol=1e-4, rtol=1e-4)
    assert interface.row_write_counts()["index_copy"] == 2 * (off + steps)


def _search(cfg, params, **kw):
    audio, lens = _audio()
    rec = Recognizer(cfg, params, device="cpu")
    return rec.decode_result(audio, lens, beam_size=BEAM, max_len=STEPS, alpha=1.0, **kw)


def test_suppression_keeps_its_ids_out_of_every_hypothesis():
    cfg = _config()
    got = _search(cfg, _params(cfg))
    assert not np.isin(got.tokens.numpy(), SUPPRESS).any()
    assert not np.isin(got.tokens[:, :, 0].numpy(), FIRST).any()
    # Without the suppression the same weights emit a banned id.
    free = _search(_config(**{"decode.suppress": (), "decode.suppress_first": ()}),
                   _params(cfg))
    assert np.isin(free.tokens.numpy(), SUPPRESS[2:] + FIRST).any()
    always, first = beam.Prompt.of(cfg.decode).ban_rows(40, "cpu")
    assert (always < 0).nonzero()[:, 0].tolist() == sorted(SUPPRESS)
    assert (first < 0).nonzero()[:, 0].tolist() == sorted(SUPPRESS + FIRST)


def test_beam_search_matches_the_reference_search_and_judge():
    cfg = _config()
    params = _params(cfg)
    got = _search(cfg, params)
    audio, lens = _audio()
    d = cfg.to_dict()
    scores, tokens = ref.beam_search(params, d, audio, lens, BEAM, STEPS, 1.0)
    assert torch.equal(got.tokens.long(), tokens)
    assert got.lengths.eq(STEPS).all()
    torch.testing.assert_close(got.scores.double(), scores, atol=1e-5, rtol=0)
    judged, gaps = ref.judge(params, d, audio, lens, got.tokens, got.lengths, 1.0)
    torch.testing.assert_close(got.scores.double(), judged, atol=1e-5, rtol=0)
    assert max(gaps) < 1e-5


def test_the_arena_path_equals_the_eager_search():
    cfg = _config()
    params = _params(cfg)
    rec = Recognizer(cfg, params, device="cpu")
    audio, lens = _audio()
    eager = rec.decode_result(audio, lens, beam_size=BEAM, max_len=STEPS, alpha=1.0)
    interface.reset_row_write_counts()
    arena = beam_graph.graph_beam_decode(rec.model, audio, lens, cfg.features, beam_size=BEAM,
                                         max_len=STEPS, alpha=1.0, prompt=rec.prompt)
    for a, b in zip((eager.tokens, eager.lengths, eager.scores),
                    (arena.tokens, arena.lengths, arena.scores)):
        assert torch.equal(a, b)
    assert interface.row_write_counts() == {"kernel": 0,
                                            "index_copy": 2 * (len(PROMPT) - 1 + arena.steps)}


def test_paths_whisper_lacks_refuse():
    from speech_tranformer_pytorch_tpu_torch import serving
    from speech_tranformer_pytorch_tpu_torch.train import create_train_state

    cfg = _config()
    params = _params(cfg)
    for over in ({"model.ctc_head": True}, {"decode.int8_weights": True},
                 {"decode.int8_kv_cache": True}, {"model.encoder": "conformer"},
                 {"model.attention_impl": "ring"}, {"model.normalize_before": False}):
        with pytest.raises(ValueError, match="single-device pre-LN beam search"):
            _config(**over)
    for over in ({"features.kind": "htk"}, {"model.stem": "conv3d"},
                 {"model.activation": "swish"}, {"decode.prompt": (1, 99)}):
        with pytest.raises(ValueError, match="invalid config"):
            _config(**over)
    with pytest.raises(ValueError, match="training path"):
        create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="a mesh and int8"):
        Recognizer(cfg, params, device="cpu", mesh=types.SimpleNamespace(device="cpu"))
    with pytest.raises(ValueError, match="cannot be exported"):
        serving.export_recognizer(cfg, params, batch_size=1, frames=200, beam_size=BEAM,
                                  max_len=4, device="cpu")
    audio, lens = _audio()
    with pytest.raises(ValueError, match="greedy search"):
        Recognizer(cfg, params, device="cpu").decode_result(audio, lens, beam_size=1,
                                                             max_len=4, alpha=1.0)
    model = _model(cfg, params)
    memory, mem_lens = _memory(cfg, params)
    with pytest.raises(ValueError, match="use_lineage=False"):
        beam.beam_search(model, memory, mem_lens, beam_size=BEAM, max_len=4,
                         use_lineage=False, prompt=beam.Prompt.of(cfg.decode))


@pytest.mark.parametrize("preset", ["tiny", "base", "large", "librispeech", "sharded"])
def test_jax_presets_keep_their_dictionary_and_hashes(preset):
    port, jax = config.get_config(preset), jcfg.get_config(preset)
    assert port.jax_dict() == jax.to_dict()
    assert port.config_hash() == jax.config_hash()
    assert port.model_hash() == jax.model_hash()
    assert config.serving_only_fields(port) == []
