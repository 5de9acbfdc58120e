"""SpeechTransformer — the encoder-decoder assembly (counterpart of the JAX
package's ``models/transformer.py``).

With ``model.ctc_head`` (the port's own field) the model is the hybrid
CTC/attention Transformer (Watanabe et al., 2017; ESPnet's LibriSpeech
recipe): a CTC head, one Linear d_model -> V over the encoder output,
whose blank is the pad id 0. ``ctc_log_probs`` gives its float32
log-softmax; the train step weighs its loss in (``train.ctc_weight``) and
the beam search its prefix scores (``decode.ctc_weight``).

``model.encoder`` (the port's own field) picks the encoder: the
Speech-Transformer's (``models/encoder.py``) or ESPnet's Conformer
(``models/conformer.py``); the decoder and the CTC head are the same."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..kernels.ctc_prefix import LOGZERO
from ..ops import masks as mask_ops
from .conformer import ConformerEncoder
from .decoder import Cache, Decoder
from .encoder import Encoder
from .modules import PositionalEncoding

CTC_BLANK = 0        # the pad id, as ESPnet's blank is id 0


class SpeechTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        """``mesh`` (a ``parallel.mesh.Mesh``): the model rank's tensor-
        parallel shards (``parallel/sharding.shard_params`` makes its
        ``state_dict``), with ring attention for
        ``attention_impl='ring'``. Every ``model.subsample_impl`` builds the
        same ``Conv2dSubsampling`` (see its docstring)."""
        super().__init__()
        if mesh is not None:
            if cfg.encoder == "conformer":
                raise ValueError("model.encoder='conformer' is single-device: its relative-"
                                 "position attention and convolution have no tensor-"
                                 "parallel form")
            tp = mesh.tp
            split = {"model.num_heads": cfg.num_heads, "model.d_ff": cfg.d_ff,
                     "model.d_model": cfg.d_model}
            if not cfg.share_embedding:
                split["model.vocab_size"] = cfg.vocab_size
            bad = [f"{k}={v}" for k, v in split.items() if v % tp]
            if bad:
                raise ValueError(f"tensor parallelism over {tp} ranks needs "
                                 f"{', '.join(bad)} divisible by {tp}")
            if cfg.ctc_head:
                raise ValueError("model.ctc_head is single-device: the CTC head "
                                 "has no tensor-parallel form")
        self.cfg = cfg
        self.mesh = mesh
        self.encoder = (ConformerEncoder(cfg, mesh) if cfg.encoder == "conformer"
                        else Encoder(cfg, mesh))
        self.decoder = Decoder(cfg, mesh)
        self.ctc = nn.Linear(cfg.d_model, cfg.vocab_size) if cfg.ctc_head else None

    def forward(self, feats, frame_lens, targets_in, tgt_lens, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None, ctc: bool = False):
        """Teacher-forced forward; returns logits [B, U, V] (f32).
        ``deterministic=False`` turns dropout on, its bits drawn from
        ``generator``. ``ctc=True`` returns (logits, the CTC log-probs
        [B, T', V] of ``ctc_log_probs``, the encoder's lengths)."""
        kw = dict(deterministic=deterministic, generator=generator)
        memory, mem_lens = self.encoder(feats, frame_lens, **kw)
        logits = self.decoder(targets_in, tgt_lens, memory, mem_lens, **kw)
        if ctc:
            return logits, self.ctc_log_probs(memory, mem_lens), mem_lens
        return logits

    def ctc_log_probs(self, memory: torch.Tensor, mem_lens: torch.Tensor) -> torch.Tensor:
        """float32 [B, T', V] log-softmax of the CTC head over ``memory``
        (compute-dtype operands, float32 products and sums, as the decoder's
        logits). Frames past ``mem_lens`` read as ESPnet pads them: blank
        with log-prob 0, every other id log 0 (``kernels/ctc_prefix.LOGZERO``)."""
        if self.ctc is None:
            raise ValueError("the model has no CTC head (model.ctc_head=False)")
        logits = torch.addmm(self.ctc.bias.float(), memory.flatten(0, 1).float(),
                             self.ctc.weight.float().t()).unflatten(0, memory.shape[:2])
        logp = torch.log_softmax(logits, dim=-1)
        pad = torch.full((logp.shape[-1],), LOGZERO, device=logp.device)
        pad[CTC_BLANK].fill_(0.0)   # on the device: a CUDA graph can capture it
        valid = mask_ops.length_mask(mem_lens, logp.shape[1])[..., None]
        return torch.where(valid, logp, pad)

    def encode(self, feats, frame_lens) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(feats, frame_lens)

    def init_cache(self, memory, max_len: int, beam_width: int = 1,
                   int8_kv: bool = False, store=None) -> Cache:
        return self.decoder.init_cache(memory, max_len, beam_width, int8_kv, store)

    def decode_step(self, tokens, index, cache, mem_lens, beam_width, lineage):
        return self.decoder.decode_step(tokens, index, cache, mem_lens,
                                        beam_width, lineage)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SpeechTransformer":
        """Seeded random weights: normal(0, 1/fan_in) kernels (LeCun), zero
        biases, unit LayerNorm scales, normal(0, 1/d) embeddings and learned
        position rows; a Conformer's BatchNorm at its defaults and its
        position biases drawn (``ConformerEncoder.init_extra``). Draws on ``generator``'s device;
        build on the CPU to share weights across devices."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                                 generator=generator)
            elif isinstance(m, PositionalEncoding) and isinstance(m.pe, nn.Parameter):
                m.pe.normal_(0.0, 1.0 / math.sqrt(m.pe.shape[1]), generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
        if isinstance(self.encoder, ConformerEncoder):
            self.encoder.init_extra(generator)
        return self
