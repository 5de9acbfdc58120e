"""Speech-Transformer decoder (counterpart of the JAX package's
``models/decoder.py``): embed·√d + PE → N × {masked self-attention,
cross-attention, feed-forward} → final LayerNorm → logits, with the output
projection tied to the embedding by default.

Two modes: the teacher-forced ``forward`` and the one-token ``decode_step``
over a KV cache. Cache layout per layer, for a step batch of B·K rows:
  self_k/self_v   : [B·K, max_len, H, D], written at ``index`` in place
  cross_k/cross_v : [B, H, S, D] head-major, beam-invariant, built once
                    (cross_k in f32, the dtype its scores are taken in)
and, with the tied output projection, ``cache["logits"]["table_f32"]``.
The self cache is never reordered by the beam search: self-attention reads
it through the lineage table (``kernels/interface.lineage_attention``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..kernels import interface
from ..ops import masks as mask_ops
from ..ops.dropout import dropout
from .modules import FeedForward, LayerNorm, MultiHeadAttention, PositionalEncoding

Cache = Dict[str, Dict[str, torch.Tensor]]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.normalize_before = cfg.normalize_before
        self.dropout_rate = cfg.dropout_rate
        self.self_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                            fused_qkv=cfg.fused_qkv,
                                            dropout_rate=cfg.attention_dropout_rate)
        self.cross_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                             dropout_rate=cfg.attention_dropout_rate)
        self.ffn = FeedForward(cfg.d_model, cfg.d_ff, cfg.dropout_rate)
        self.ln1 = LayerNorm(cfg.d_model)
        self.ln2 = LayerNorm(cfg.d_model)
        self.ln3 = LayerNorm(cfg.d_model)

    def forward(self, x, memory, tgt_lens, mem_lens, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced layer: causal self-attention over the first
        ``tgt_lens`` targets, cross-attention over ``mem_lens`` frames."""
        kw = dict(deterministic=deterministic, generator=generator)
        drop = lambda y: dropout(y, self.dropout_rate, **kw)
        self_attend = lambda h: self.self_attn(h, h, kv_lengths=tgt_lens, causal=True,
                                               deterministic=deterministic)
        cross_attend = lambda h: self.cross_attn(h, memory, kv_lengths=mem_lens,
                                                 deterministic=deterministic)
        if self.normalize_before:
            x = x + drop(self_attend(self.ln1(x)))
            x = x + drop(cross_attend(self.ln2(x)))
            return x + drop(self.ffn(self.ln3(x), **kw))
        x = self.ln1(x + drop(self_attend(x)))
        x = self.ln2(x + drop(cross_attend(x)))
        return self.ln3(x + drop(self.ffn(x, **kw)))

    # ----- step decoding ---------------------------------------------------

    def init_layer_cache(self, memory: torch.Tensor, batch: int,
                         max_len: int) -> Dict[str, torch.Tensor]:
        """``memory`` is the untiled [B,S,d]; ``batch`` is the step batch B·K."""
        ck, cv = self.cross_attn.project_kv(memory)            # [B,S,H,D]
        h, d = ck.shape[-2:]
        zeros = torch.zeros((batch, max_len, h, d), dtype=memory.dtype,
                            device=memory.device)
        # cross_k is kept in f32: every step takes its scores in f32, and
        # the compute-dtype values are exact there, so it is cast once here.
        return {"self_k": zeros, "self_v": torch.zeros_like(zeros),
                "cross_k": ck.transpose(1, 2).float().contiguous(),  # [B,H,S,D]
                "cross_v": cv.transpose(1, 2).contiguous()}

    def decode_step(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    index: int, cross_bias: torch.Tensor, beam_width: int,
                    lineage: torch.Tensor) -> torch.Tensor:
        """x [B·K, 1, d] at position ``index``; writes this position's k/v
        into ``cache`` in place (saves a copy of the cache per step)."""

        def self_attend(h):
            q_new, k_new, v_new = self.self_attn.project_qkv(h)   # [B·K,1,H,D]
            cache["self_k"][:, index] = k_new[:, 0]
            cache["self_v"][:, index] = v_new[:, 0]
            out = interface.lineage_attention(
                q_new, cache["self_k"], cache["self_v"], lineage, index,
                beam_width)
            return self.self_attn.out(out.flatten(-2))

        def cross_attend(h):
            # Fold the K beams into query rows: the cross cache is
            # beam-invariant, so it is read once per utterance.
            bk, _, d = h.shape
            out = self.cross_attn.attend_bhsd(
                h.reshape(bk // beam_width, beam_width, d), cache["cross_k"],
                cache["cross_v"], cross_bias)
            return out.reshape(bk, 1, d)

        if self.normalize_before:
            x = x + self_attend(self.ln1(x))
            x = x + cross_attend(self.ln2(x))
            return x + self.ffn(self.ln3(x))
        x = self.ln1(x + self_attend(x))
        x = self.ln2(x + cross_attend(x))
        return self.ln3(x + self.ffn(x))


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.d_model = cfg.d_model
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.max_target_positions,
                                          cfg.dropout_rate)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.num_decoder_layers))
        self.final_norm = LayerNorm(cfg.d_model)
        self.out_proj = (None if cfg.share_embedding else
                         nn.Linear(cfg.d_model, cfg.vocab_size, bias=False))

    def _logits(self, x: torch.Tensor,
                table_f32: Optional[torch.Tensor] = None) -> torch.Tensor:
        """float32 logits: compute-dtype operands, f32 accumulation and
        result (products of bf16 values are exact in f32). ``table_f32`` is
        the tied embedding already cast to f32, as ``init_cache`` keeps it."""
        if self.out_proj is None:
            if table_f32 is None:
                table_f32 = self.embed.weight.float()
            return torch.matmul(x.float(), table_f32.t())
        return self.out_proj(x).float()

    def _embed_scaled(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.embed(tokens)
        scale = torch.tensor(self.d_model ** 0.5, dtype=emb.dtype, device=emb.device)
        return emb * scale

    def forward(self, targets_in, tgt_lens, memory, mem_lens, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced decode; returns logits [B, U, V] (f32). Rows past
        ``tgt_lens`` are finite and meaningless (the loss weights them 0)."""
        kw = dict(deterministic=deterministic, generator=generator)
        x = self.pos_enc(self._embed_scaled(targets_in), **kw)
        mem = memory.to(x.dtype)
        for layer in self.layers:
            x = layer(x, mem, tgt_lens, mem_lens, **kw)
        return self._logits(self.final_norm(x))

    # ----- step decoding ---------------------------------------------------

    def init_cache(self, memory: torch.Tensor, max_len: int,
                   beam_width: int = 1) -> Cache:
        """KV cache for B·beam_width step rows; ``memory`` is untiled [B,S,d]."""
        if max_len > self.pos_enc.max_len:
            raise ValueError(f"max_len {max_len} exceeds the positional table "
                             f"({self.pos_enc.max_len})")
        b = memory.shape[0] * beam_width
        mem = memory.to(self.embed.weight.dtype)
        cache = {f"layer_{i}": layer.init_layer_cache(mem, b, max_len)
                 for i, layer in enumerate(self.layers)}
        if self.out_proj is None:   # cast the tied projection once, not per step
            cache["logits"] = {"table_f32": self.embed.weight.float()}
        return cache

    def decode_step(self, tokens: torch.Tensor, index: int, cache: Cache,
                    mem_lens: torch.Tensor, beam_width: int,
                    lineage: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One step. Returns (logits [B·K, V] f32, the cache updated in place).

        ``lineage`` [B, K, max_len] int32 names the cache lane that holds
        beam k's step-j entry."""
        s = cache["layer_0"]["cross_k"].shape[2]
        x = self._embed_scaled(tokens[:, None])                # [B·K,1,d]
        x = x + self.pos_enc.pe[index:index + 1][None].to(x.dtype)
        cross_bias = mask_ops.mask_to_bias(
            mask_ops.padding_attention_mask(1, mem_lens, s))
        for i, layer in enumerate(self.layers):
            x = layer.decode_step(x, cache[f"layer_{i}"], index, cross_bias,
                                  beam_width, lineage)
        table_f32 = cache.get("logits", {}).get("table_f32")
        return self._logits(self.final_norm(x), table_f32)[:, 0, :], cache
