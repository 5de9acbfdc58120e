"""Recognizer (counterpart of the JAX package's ``recognize.py``): int16
PCM -> fbank + CMVN -> encoder -> beam search (greedy at beam 1) -> best
hypotheses with <eos> removed; ``decode_manifest`` decodes a manifest in
length buckets and scores it by CER (and WER for a BPE vocabulary) and
real-time factor; ``load_recognizer`` serves a checkpoint.

With a ``parallel.mesh.Mesh`` the model holds the rank's tensor-parallel
shards and a batch splits over ``data`` (``parallel/decode.py``);
``decode_manifest(distributed=True)`` gives each data rank its stride of
every globally planned batch and gathers hypotheses with their manifest
rows, so every rank returns the same scores."""

from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional, Union

import torch
import torch.distributed as dist

from .config import ExperimentConfig, serving_only_fields
from .data.features import extract_features
from .data.pipeline import (BucketedBatcher, ManifestDataset, _frames_for_samples)
from .data.tokenizer import EOS, load_tokenizer
from .decoding import (BeamResult, GreedyResult, beam_decode, best_hypotheses,
                       greedy_decode, tokens_to_lists)
from .decoding.beam import Prompt, check_ctc_search, replays_graphs
from .decoding.beam_graph import graph_beam_decode
from .device import DeviceLike, resolve_device
from .models import SpeechTransformer
from .models.modules import subsampled_lengths
from .ops.metrics import cer, wer
from .ops.quantize import decode_model, quantize_params
from .parallel.decode import make_sharded_beam_decode, make_sharded_greedy_decode
from .parallel.sharding import data_rows, gather_rows, shard_params
from .utils.checkpoint import Checkpointer
from .utils.profiling import named_scope


class Recognizer:
    def __init__(self, cfg: ExperimentConfig, params: Dict[str, torch.Tensor], *,
                 tokenizer=None, device: DeviceLike = None, mesh=None):
        """``params`` is a float32 ``state_dict`` of ``SpeechTransformer``
        (``convert.params_from_jax`` makes one from a JAX checkpoint tree).
        The model lives on ``device`` (CUDA unless the caller asks for the
        CPU); inference never updates params, so they are cast to the
        compute dtype ``model.dtype`` once, here.

        ``decode.int8_weights``: the weights are quantized from the f32
        params (per-row int8 embedding included) and served by
        ``ops.quantize.decode_model``: encoder dequantized once, decoder
        dense layers on the int8 kernels. ``decode.int8_kv_cache``: int8
        cross K/V cache. ``tokenizer`` turns hypotheses into text for
        ``decode_manifest``'s output file and WER.

        ``mesh``: the model holds this rank's tensor-parallel shards of
        ``params`` on ``mesh.device`` and batches split over ``data``. The
        int8 options are single-device only, as in JAX.

        ``decode.ctc_weight`` > 0 (a model with ``model.ctc_head``): the
        beam search is the hybrid CTC/attention one (``decoding/beam``);
        it has no mesh, int8 or greedy path, and those raise.

        Whisper's port-only fields (``config.SERVING_ONLY``: its front
        end, stem, positions, a forced ``decode.prompt`` and suppressed
        ids) are served by the single-device beam search alone: a mesh or
        int8 serving refuses them here, greedy search at its call."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        dt = getattr(torch, cfg.model.dtype)
        self.int8_kv = bool(cfg.decode.int8_kv_cache)
        self.ctc_weight = float(cfg.decode.ctc_weight)
        self.prompt = Prompt.of(cfg.decode)
        only = serving_only_fields(cfg)
        if only and (mesh is not None or cfg.decode.int8_weights or self.int8_kv):
            raise ValueError(f"{only} are served by the single-device beam search alone: "
                             f"a mesh and int8 serving have no path for them")
        if mesh is not None:
            if cfg.decode.int8_weights or self.int8_kv:
                raise ValueError("decode.int8_weights / decode.int8_kv_cache are "
                                 "single-device serving only: disable them for "
                                 "mesh or distributed decoding")
            model = SpeechTransformer(cfg.model, mesh)
            model.load_state_dict(shard_params(params, mesh.tp, mesh.model_index))
            self.model = model.to(self.device, dt)
        elif cfg.decode.int8_weights:
            qparams, scales = quantize_params(params, cfg.model, embedding_rows=True)
            self.model = decode_model(cfg.model, qparams, scales, dt).to(self.device)
        else:
            model = SpeechTransformer(cfg.model)
            model.load_state_dict(params)
            self.model = model.to(self.device, dt)
        self.model.eval()
        if self.ctc_weight > 0.0:
            check_ctc_search(self.model, cfg.decode.int8_weights or self.int8_kv)
        self.last_steps = 0

    def decode_result(self, audio_int16, sample_lens, *, beam_size: int,
                      max_len: int, alpha: float) -> Union[BeamResult, GreedyResult]:
        """Decode a padded int16 batch [B, S]: beam search, or greedy search
        when ``beam_size == 1`` (as the JAX ``Recognizer`` routes it). With
        a mesh the batch is the global one: each data rank decodes its
        rows and the result is gathered back in row order."""
        with named_scope("st.recognize"):
            if self.mesh is not None:
                audio_int16, sample_lens = (data_rows(torch.as_tensor(x), self.mesh)
                                            for x in (audio_int16, sample_lens))
            return self._decode(audio_int16, sample_lens, beam_size=beam_size,
                                max_len=max_len, alpha=alpha)

    def _decode(self, audio_int16, sample_lens, *, beam_size: int, max_len: int,
                alpha: float) -> Union[BeamResult, GreedyResult]:
        """Decode the rows this process holds; with a mesh, through the
        sharded builders (``parallel/decode.py``), which gather every data
        rank's rows. A beam search on a card without a mesh starts from the
        PCM on the model's graph arena (``beam_graph.graph_beam_decode``:
        the features, encoder and caches replayed as one CUDA graph a call
        shape); everything else extracts the features, then decodes."""
        if (beam_size > 1 and self.mesh is None
                and replays_graphs(self.model, self.device, max_len, True)):
            result = graph_beam_decode(self.model, audio_int16, sample_lens,
                                       self.cfg.features, beam_size=beam_size,
                                       max_len=max_len, alpha=alpha, int8_kv=self.int8_kv,
                                       ctc_weight=self.ctc_weight, prompt=self.prompt)
            self.last_steps = result.steps
            return result
        feats, frame_lens = extract_features(audio_int16, sample_lens,
                                             self.cfg.features, device=self.device)
        if self.mesh is not None:
            fn = (make_sharded_greedy_decode(self.model, self.mesh, max_len=max_len)
                  if beam_size == 1 else
                  make_sharded_beam_decode(self.model, self.mesh, beam_size=beam_size,
                                           max_len=max_len, alpha=alpha))
            result = fn(feats, frame_lens)
        elif beam_size == 1:
            if self.ctc_weight > 0.0:
                raise ValueError("greedy search (beam 1) has no CTC prefix scorer: "
                                 "decode.ctc_weight > 0 needs beam_size > 1")
            if self.prompt is not None:
                raise ValueError("greedy search (beam 1) has no forced prompt or "
                                 "suppression: decode.prompt / decode.suppress need "
                                 "beam_size > 1")
            result = greedy_decode(self.model, feats, frame_lens, max_len=max_len,
                                   int8_kv=self.int8_kv, device=self.device)
        else:
            result = beam_decode(self.model, feats, frame_lens, beam_size=beam_size,
                                 max_len=max_len, alpha=alpha, int8_kv=self.int8_kv,
                                 device=self.device, ctc_weight=self.ctc_weight,
                                 prompt=self.prompt)
        self.last_steps = result.steps
        return result

    def decode_batch(self, audio_int16, sample_lens, *, beam_size: int,
                     max_len: int, alpha: float) -> List[List[int]]:
        """Best hypothesis of each utterance, <eos> removed."""
        return self.hypotheses(self.decode_result(
            audio_int16, sample_lens, beam_size=beam_size, max_len=max_len, alpha=alpha))

    @staticmethod
    def hypotheses(result: Union[BeamResult, GreedyResult]) -> List[List[int]]:
        """Best hypothesis of each utterance of a decode result, <eos> removed."""
        hyps = (tokens_to_lists(result) if isinstance(result, GreedyResult)
                else best_hypotheses(result))
        return [[x for x in h if x != EOS] for h in hyps]

    def decode_manifest(self, manifest_path: str, *, beam_size: Optional[int] = None,
                        max_len: Optional[int] = None, alpha: Optional[float] = None,
                        batch_size: int = 16, max_frames_per_batch: int = 0,
                        out_path: Optional[str] = None,
                        distributed: bool = False) -> Dict[str, float]:
        """Decode and score a manifest, in the JAX ``decode_manifest``'s
        length buckets and order. Returns ``cer`` (with ``errors`` and
        ``ref_tokens``), ``wer`` for a BPE tokenizer, ``rtf`` (decode wall
        time over audio time, first call of each batch shape and decode
        setting left out), ``rtf_with_compile`` (every call),
        ``audio_seconds`` and ``utterances``. On a card the first call of a
        shape pays one-time costs (library handles and algorithm choices,
        allocator growth), as JAX's pays its compile; when every batch was
        a first call, the epoch runs again for ``rtf``. ``out_path`` gets
        one JSON line an utterance.

        ``distributed=True`` (a mesh is needed): each data rank reads and
        decodes its stride of every globally planned batch (``batch_size``
        is per data rank), then the hypotheses and their manifest rows are
        gathered over ``data``, so every rank scores the whole manifest
        and returns the same scores; only rank 0 writes ``out_path``.
        Without it a multi-rank launch raises, as JAX's does."""
        mesh = self.mesh
        if distributed and mesh is None:
            raise ValueError("decode_manifest(distributed=True) needs a mesh: "
                             "construct the Recognizer with mesh=... "
                             "(recognize_cli --distributed builds one)")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if not distributed and world > 1:
            raise RuntimeError(
                f"decode_manifest without distributed=True under a {world}-rank "
                "launch: every rank would decode the whole manifest; pass "
                "distributed=True (recognize_cli --distributed)")
        num_shards = mesh.dp if distributed else 1
        d = self.cfg.decode
        beam_size = beam_size if beam_size is not None else d.beam_size
        max_len = max_len if max_len is not None else d.max_decode_len
        alpha = alpha if alpha is not None else d.length_penalty

        ds = ManifestDataset(manifest_path, self.cfg.data, self.cfg.features)
        batcher = BucketedBatcher(
            ds, batch_size=batch_size, bucket_boundaries=self.cfg.data.bucket_boundaries,
            target_len=min(self.cfg.data.max_target_len,
                           self.cfg.model.max_target_positions),
            shuffle=False, drop_remainder=False,
            shard_index=mesh.data_index if distributed else 0, num_shards=num_shards,
            max_frames_per_batch=max_frames_per_batch,
            adaptive_target_len=self.cfg.data.adaptive_target_len)
        if mesh is not None:
            # Every global batch (per-rank rows × shards) must divide the
            # data axis: round the per-rank bucket sizes up (JAX
            # recognize.py:241-250); padded rows carry valid=False.
            q = mesh.dp // math.gcd(mesh.dp, num_shards)
            batcher.bucket_batch_sizes = [-(-b // q) * q
                                          for b in batcher.bucket_batch_sizes]

        def batch_max_len(abatch) -> int:
            """Decode steps for the batch: ``max_len``, or with
            ``max_len_ratio`` that ratio of the bucket's encoder frames
            (the encoder's exact subsampled length), at least 4."""
            if d.max_len_ratio <= 0:
                return max_len
            frames = _frames_for_samples(int(abatch.audio.shape[1]), self.cfg.features)
            enc_frames = int(subsampled_lengths(torch.tensor(frames)))
            return max(4, min(max_len, int(d.max_len_ratio * enc_frames)))

        def decode(abatch, rows):
            """(manifest rows, their hypotheses) of the batch, padding rows
            dropped (with ``distributed``, every data rank's, gathered with
            their row ids), the decode wall time, device work included, and
            the batch's step limit."""
            bml = batch_max_len(abatch)
            t0 = time.perf_counter()
            if not distributed:
                hyps = self.decode_batch(abatch.audio, abatch.sample_lens,
                                         beam_size=beam_size, max_len=bml, alpha=alpha)
                return list(rows), hyps[:len(rows)], time.perf_counter() - t0, bml
            result = self._decode(abatch.audio, abatch.sample_lens, beam_size=beam_size,
                                  max_len=bml, alpha=alpha)
            ids = torch.full((abatch.audio.shape[0],), -1, dtype=torch.int64)
            ids[:len(rows)] = torch.tensor(rows, dtype=torch.int64)
            ids = gather_rows(ids.to(self.device), mesh).cpu()
            keep = torch.nonzero(ids >= 0)[:, 0].tolist()
            hyps = self.hypotheses(result)
            return ([int(ids[i]) for i in keep], [hyps[i] for i in keep],
                    time.perf_counter() - t0, bml)

        sr = self.cfg.features.sample_rate
        refs, hyps, utt_ids, ref_rows = [], [], [], []
        audio_total = t_total = audio_steady = t_steady = 0.0
        seen = set()
        for abatch, rows in batcher.epoch(0, with_rows=True):
            rows, out, dt, bml = decode(abatch, rows)
            batch_audio = sum(ds.entries[i]["num_samples"] for i in rows) / sr
            t_total += dt
            audio_total += batch_audio
            key = (tuple(abatch.audio.shape), beam_size, bml, alpha)
            if key in seen:
                t_steady += dt
                audio_steady += batch_audio
            else:
                seen.add(key)
            for idx, h in zip(rows, out):
                e = ds.entries[idx]
                refs.append(e["tokens"])
                ref_rows.append(idx)
                hyps.append(h)
                utt_ids.append(e["utt_id"])

        if audio_steady == 0.0 and audio_total > 0.0:
            for abatch, rows in batcher.epoch(0, with_rows=True):
                rows, _, dt, _ = decode(abatch, rows)
                t_steady += dt
                audio_steady += sum(ds.entries[i]["num_samples"] for i in rows) / sr

        scores = cer(refs, hyps)
        if self.tokenizer is not None and hasattr(self.tokenizer, "merges"):
            # BPE outputs: word error rate against the manifest's text (the
            # token-level ``cer`` stays as the subword error rate).
            ref_words = [ds.entries[i]["text"].split() for i in ref_rows]
            hyp_words = [self.tokenizer.decode(h).split() for h in hyps]
            scores["wer"] = wer(ref_words, hyp_words)["wer"]
        scores["rtf"] = t_steady / max(audio_steady, 1e-9)
        scores["rtf_with_compile"] = t_total / max(audio_total, 1e-9)
        scores["audio_seconds"] = audio_total
        scores["utterances"] = float(len(hyps))

        if out_path and (mesh is None or mesh.is_main):
            with open(out_path, "w", encoding="utf-8") as f:
                for uid, h in zip(utt_ids, hyps):
                    text = self.tokenizer.decode(h) if self.tokenizer is not None else ""
                    f.write(json.dumps({"utt_id": uid, "tokens": h, "text": text},
                                       ensure_ascii=False) + "\n")
        return scores


def load_recognizer(cfg: ExperimentConfig, checkpoint_dir: str, *,
                    vocab_path: Optional[str] = None,
                    device: DeviceLike = None, mesh=None) -> Recognizer:
    """A ``Recognizer`` on ``device`` (CUDA unless the caller asks for the
    CPU), or on ``mesh`` with this rank's shards, serving the latest
    checkpoint in ``checkpoint_dir`` (a mesh run's checkpoint is whole and
    loads either way)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    _, restored = Checkpointer(checkpoint_dir).restore(device="cpu")
    tok = load_tokenizer(vocab_path) if vocab_path else None
    return Recognizer(cfg, restored.params, tokenizer=tok, device=dev, mesh=mesh)
