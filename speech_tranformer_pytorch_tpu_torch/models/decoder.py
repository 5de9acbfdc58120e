"""Speech-Transformer decoder (counterpart of the JAX package's
``models/decoder.py``): embed·√d + PE → N × {masked self-attention,
cross-attention, feed-forward} → final LayerNorm → logits, with the output
projection tied to the embedding by default.

Whisper's decoder (``whisper/model.py`` ``TextDecoder``) is this one with
port-only fields: learned positions (``model.decoder_positions``), no
embedding scale, GELU and ``model.layer_norm_eps`` (Whisper's keys have
no bias: the port's key biases load as zeros).

Two modes: the teacher-forced ``forward`` and the one-token ``decode_step``
over a KV cache. Cache layout per layer, for a step batch of B·K rows:
  self_k/self_v   : [B·K, max_len, H, D], written at ``index`` in place
  cross_k/cross_v : [B, H, S, D] head-major, beam-invariant, built once
                    in the compute dtype (each step takes its scores in
                    f32 from those values, ``MultiHeadAttention.attend_bhsd``);
                    with ``int8_kv`` both int8, with per-(B, H, 1, D)
                    scales ``cross_k_scale``/``cross_v_scale``
The step index is a 0-d int32 tensor on the cache's device at every call.
For int8 serving (``ops/quantize.decode_model``) ``Decoder.use_int8`` swaps
the dense layers for ``Int8Linear`` and the embedding for ``Int8Embedding``.
By default the beam search never reorders the self cache: self-attention
reads it through the lineage table, and the same call writes the step's
row (``kernels/interface.lineage_attention_step``); with
``use_lineage=False`` it gathers the cache by beam and attends in plain
PyTorch.
With ``model.remat`` each teacher-forced layer runs under
``ops/remat.remat_module`` while gradients are taken (JAX
``decoder.py:268-272``).

With a ``mesh`` the layers are tensor-parallel (``models/modules.py``),
the embedding holds d_model/tp columns, gathered over the model ranks
after the lookup, and the tied output projection multiplies the rank's
slice of d_model by its embedding columns and sums the partial logits
over the model ranks; an untied one gives vocabulary shards, which are
gathered. The loss and the beam prune then see whole [.., V] logits, as
in JAX's GSPMD program, and the caches hold the rank's heads.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..kernels import interface
from ..ops import masks as mask_ops
from ..ops.dropout import dropout
from ..ops.remat import remat_module
from ..parallel.tp import (column_linear, copy_to_model, gather_from_model,
                           local_slice, reduce_from_model)
from .modules import (ACTIVATIONS, FeedForward, Int8Embedding, Int8Linear, LayerNorm,
                      MultiHeadAttention, PositionalEncoding, dot_product_attention)

Cache = Dict[str, Dict[str, torch.Tensor]]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.normalize_before = cfg.normalize_before
        self.dropout_rate = cfg.dropout_rate
        self.self_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                            fused_qkv=cfg.fused_qkv,
                                            dropout_rate=cfg.attention_dropout_rate,
                                            remat=cfg.attention_remat, mesh=mesh)
        self.cross_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                             dropout_rate=cfg.attention_dropout_rate,
                                             remat=cfg.attention_remat, mesh=mesh)
        self.ffn = FeedForward(cfg.d_model, cfg.d_ff, cfg.dropout_rate, mesh,
                               activation=ACTIVATIONS[cfg.activation])
        self.ln1 = LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ln2 = LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ln3 = LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x, memory, tgt_lens, mem_lens, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced layer: causal self-attention over the first
        ``tgt_lens`` targets, cross-attention over ``mem_lens`` frames."""
        kw = dict(deterministic=deterministic, generator=generator)
        drop = lambda y: dropout(y, self.dropout_rate, **kw)
        self_attend = lambda h: self.self_attn(h, h, kv_lengths=tgt_lens, causal=True,
                                               q_lengths=tgt_lens, **kw)
        cross_attend = lambda h: self.cross_attn(h, memory, kv_lengths=mem_lens, **kw)
        if self.normalize_before:
            x = x + drop(self_attend(self.ln1(x)))
            x = x + drop(cross_attend(self.ln2(x)))
            return x + drop(self.ffn(self.ln3(x), **kw))
        x = self.ln1(x + drop(self_attend(x)))
        x = self.ln2(x + drop(cross_attend(x)))
        return self.ln3(x + drop(self.ffn(x, **kw)))

    # ----- step decoding ---------------------------------------------------

    def init_layer_cache(self, memory: torch.Tensor, batch: int, max_len: int,
                         int8_kv: bool = False) -> Dict[str, torch.Tensor]:
        """``memory`` is the untiled [B,S,d]; ``batch`` is the step batch B·K.
        ``int8_kv`` stores cross K/V as int8 with f32-derived scales per
        (B, H, 1, D), reduced over every frame, padded ones included (JAX
        ``decoder.py:110-142``); the scales are kept in the compute dtype,
        the dtype each step dequantizes in."""
        ck, cv = self.cross_attn.project_kv(memory)            # [B,S,H,D]
        h, d = ck.shape[-2:]
        zeros = torch.zeros((batch, max_len, h, d), dtype=memory.dtype,
                            device=memory.device)
        cache = {"self_k": zeros, "self_v": torch.zeros_like(zeros)}
        ck, cv = ck.transpose(1, 2), cv.transpose(1, 2)        # [B,H,S,D]
        if int8_kv:
            for name, t in (("cross_k", ck), ("cross_v", cv)):
                t = t.float()
                s = torch.amax(t.abs(), dim=2, keepdim=True) / 127.0
                s = torch.where(s == 0.0, torch.ones_like(s), s)
                cache[name] = torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
                cache[name + "_scale"] = s.to(memory.dtype)
            return cache
        cache["cross_k"] = ck.contiguous()
        cache["cross_v"] = cv.contiguous()
        return cache

    def decode_step(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    index: torch.Tensor, mem_lens: torch.Tensor, beam_width: int,
                    lineage: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B·K, 1, d] at position ``index`` (a 0-d int32 tensor on the
        cache's device), cross-attending to the first ``mem_lens`` [B]
        (int32) frames of each utterance; writes this position's k/v into
        ``cache`` in place (saves a copy of the cache per step), or, while
        ``torch.export`` traces (a step inside a ``while_loop``, which may
        not mutate its carry), puts new self K/V tensors in ``cache``.
        Self-attention reads the unpermuted cache through ``lineage``: off
        the export path one call (``interface.lineage_attention_step``)
        writes the rows and attends, taking the projection's views as they
        are; while exporting, functional ``index_copy`` and the
        ``st_port::lineage_attention`` op. With ``lineage=None`` (beam
        search's ``use_lineage=False``, whose cache is gathered by beam
        every step) it writes with ``index_copy_`` and attends over the
        cache positions <= ``index`` in plain PyTorch, as JAX's XLA path
        does."""

        def self_attend(h):
            q_new, k_new, v_new = self.self_attn.project_qkv(h)   # [B·K,1,H,D]
            exporting = torch.compiler.is_exporting()
            if lineage is not None and not exporting:   # the kernel writes the rows
                out = interface.lineage_attention_step(
                    q_new, k_new, v_new, cache["self_k"], cache["self_v"], lineage,
                    index, beam_width)
                return self.self_attn.project_out(out)
            pos = index.reshape(1).long()
            if exporting:   # a traced loop may not write its carry
                cache["self_k"] = cache["self_k"].index_copy(1, pos, k_new)
                cache["self_v"] = cache["self_v"].index_copy(1, pos, v_new)
            else:
                cache["self_k"].index_copy_(1, pos, k_new)
                cache["self_v"].index_copy_(1, pos, v_new)
                interface.count_row_writes("index_copy")
            if lineage is None:   # a beam-gathered cache: positions <= index
                pos_ok = torch.arange(cache["self_k"].shape[1], device=h.device) <= index
                out = dot_product_attention(q_new, cache["self_k"], cache["self_v"],
                                            mask_ops.mask_to_bias(pos_ok))
            else:
                out = interface.lineage_attention(
                    q_new, cache["self_k"], cache["self_v"], lineage, index,
                    beam_width)
            return self.self_attn.project_out(out)

        def cross_attend(h):
            # The K beams of an utterance are its query rows: the cross
            # cache is beam-invariant, so it is read once per utterance.
            ck, cv = cache["cross_k"], cache["cross_v"]
            if ck.dtype == torch.int8:      # per-step dequant in the compute dtype
                ck = ck.to(h.dtype) * cache["cross_k_scale"]
                cv = cv.to(h.dtype) * cache["cross_v_scale"]
            return self.cross_attn.attend_bhsd(h, ck, cv, mem_lens)

        if self.normalize_before:
            x = x + self_attend(self.ln1(x))
            x = x + cross_attend(self.ln2(x))
            return x + self.ffn(self.ln3(x))
        x = self.ln1(x + self_attend(x))
        x = self.ln2(x + cross_attend(x))
        return self.ln3(x + self.ffn(x))


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.mesh = mesh
        tp = 1 if mesh is None else mesh.tp
        self.d_model = cfg.d_model
        self.embed_scale = cfg.embed_scale
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model // tp)
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.max_target_positions,
                                          cfg.dropout_rate, cfg.decoder_positions)
        self.layers = nn.ModuleList(DecoderLayer(cfg, mesh)
                                    for _ in range(cfg.num_decoder_layers))
        self.final_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        self.out_proj = (None if cfg.share_embedding else
                         nn.Linear(cfg.d_model, cfg.vocab_size // tp, bias=False))
        self.remat = cfg.remat

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the final LayerNorm always stays float)."""
        return self.final_norm.weight.dtype

    def use_int8(self, quantized: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Swap layers for int8 ones. ``quantized`` maps a parameter name
        (``layers.0.ffn.fc1.weight``, ``embed.weight``, ...) to its int8
        values and f32 scale, as ``ops/quantize.quantize_params`` makes
        them; biases come from the layers being replaced. Call after the
        model is cast to its compute dtype."""
        dt = self.dtype
        for name, (q, s) in quantized.items():
            path, leaf = name.rsplit(".", 1)
            old = self.get_submodule(path)
            if leaf != "weight":
                raise ValueError(f"{name}: only weights are quantized")
            if isinstance(old, nn.Embedding):
                new = Int8Embedding(q, s, dt)
            elif isinstance(old, nn.Linear):
                new = Int8Linear(q, s, old.bias, dt)
            else:
                raise ValueError(f"{name}: no int8 form of {type(old).__name__}")
            parent, _, attr = path.rpartition(".")
            setattr(self.get_submodule(parent) if parent else self, attr, new)

    def _table(self) -> torch.Tensor:
        """The tied [V, d] table in the compute dtype."""
        if isinstance(self.embed, Int8Embedding):
            return self.embed.table()
        return self.embed.weight

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 logits: compute-dtype operands, f32 accumulation and
        result (products of bf16 values are exact in f32)."""
        mesh = self.mesh
        if self.out_proj is None:
            if mesh is not None:      # this rank's d_model columns
                x = local_slice(copy_to_model(x, mesh), mesh)
            return reduce_from_model(torch.matmul(x.float(), self._table().float().t()),
                                     mesh)
        return gather_from_model(column_linear(self.out_proj, x, mesh), mesh).float()

    def _embed_scaled(self, tokens: torch.Tensor) -> torch.Tensor:
        """The tokens' embedding rows, times sqrt(d_model) unless
        ``model.embed_scale`` is off (Whisper's)."""
        emb = gather_from_model(self.embed(tokens), self.mesh)
        if not self.embed_scale:
            return emb
        scale = torch.full((), self.d_model ** 0.5, dtype=emb.dtype, device=emb.device)
        return emb * scale

    def forward(self, targets_in, tgt_lens, memory, mem_lens, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced decode; returns logits [B, U, V] (f32). Rows past
        ``tgt_lens`` are finite and meaningless (the loss weights them 0)."""
        kw = dict(deterministic=deterministic, generator=generator)
        x = self.pos_enc(self._embed_scaled(targets_in), **kw)
        mem = memory.to(x.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (remat_module(layer, x, mem, tgt_lens, mem_lens, **kw) if remat
                 else layer(x, mem, tgt_lens, mem_lens, **kw))
        return self._logits(self.final_norm(x))

    # ----- step decoding ---------------------------------------------------

    def init_cache(self, memory: torch.Tensor, max_len: int,
                   beam_width: int = 1, int8_kv: bool = False,
                   store: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                   ) -> Cache:
        """KV cache for B·beam_width step rows; ``memory`` is untiled [B,S,d].
        ``int8_kv``: int8 cross K/V (``DecoderLayer.init_layer_cache``).
        ``store(name, tensor)``, given, is handed each tensor as it is made
        (names ``layer_0.self_k``, ``layer_0.cross_k``, ...) and returns
        the tensor the cache holds in its place: a static copy that a
        captured decode step reads (``decoding/beam_graph.py``). One layer
        is made at a time, so no second whole cache is alive beside it."""
        if max_len > self.pos_enc.max_len:
            raise ValueError(f"max_len {max_len} exceeds the positional table "
                             f"({self.pos_enc.max_len})")
        b = memory.shape[0] * beam_width
        mem = memory.to(self.dtype)
        keep = store or (lambda name, t: t)
        cache = {}
        for i, layer in enumerate(self.layers):
            made = layer.init_layer_cache(mem, b, max_len, int8_kv)
            cache[f"layer_{i}"] = {n: keep(f"layer_{i}.{n}", t) for n, t in made.items()}
            del made   # a stored layer's own copies go before the next is made
        return cache

    def decode_step(self, tokens: torch.Tensor, index: torch.Tensor, cache: Cache,
                    mem_lens: torch.Tensor, beam_width: int,
                    lineage: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
        """One step at position ``index``, a 0-d int32 tensor on the cache's
        device (anything else is refused). Returns (logits [B·K, V] f32, the
        updated cache).

        ``lineage`` [B, K, max_len] int32 names the cache lane that holds
        beam k's step-j entry; ``None`` for a cache gathered by beam
        (``DecoderLayer.decode_step``)."""
        device = cache["layer_0"]["self_k"].device
        if not (torch.is_tensor(index) and index.dim() == 0
                and index.dtype == torch.int32 and index.device == device):
            raise ValueError(f"a decode step index must be a 0-d int32 tensor on "
                             f"{device}, got {index!r}")
        x = self._embed_scaled(tokens[:, None])                # [B·K,1,d]
        row = self.pos_enc.pe.index_select(0, index.reshape(1))
        x = x + row[None].to(x.dtype)
        lens = mem_lens.to(torch.int32)   # what the cross-attention kernel reads
        for i, layer in enumerate(self.layers):
            x = layer.decode_step(x, cache[f"layer_{i}"], index, lens, beam_width,
                                  lineage)
        return self._logits(self.final_norm(x))[:, 0, :], cache
