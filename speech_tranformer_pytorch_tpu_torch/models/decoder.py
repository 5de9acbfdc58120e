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
from .modules import FeedForward, LayerNorm, MultiHeadAttention, PositionalEncoding

Cache = Dict[str, Dict[str, torch.Tensor]]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.normalize_before = cfg.normalize_before
        self.self_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                            fused_qkv=cfg.fused_qkv)
        self.cross_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads)
        self.ffn = FeedForward(cfg.d_model, cfg.d_ff)
        self.ln1 = LayerNorm(cfg.d_model)
        self.ln2 = LayerNorm(cfg.d_model)
        self.ln3 = LayerNorm(cfg.d_model)

    def forward(self, x, self_bias, memory, cross_bias):
        if self.normalize_before:
            h = self.ln1(x)
            x = x + self.self_attn(h, h, self_bias)
            h = self.ln2(x)
            x = x + self.cross_attn(h, memory, cross_bias)
            return x + self.ffn(self.ln3(x))
        x = self.ln1(x + self.self_attn(x, x, self_bias))
        x = self.ln2(x + self.cross_attn(x, memory, cross_bias))
        return self.ln3(x + self.ffn(x))

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
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.max_target_positions)
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

    def forward(self, targets_in, tgt_lens, memory, mem_lens) -> torch.Tensor:
        """Teacher-forced decode; returns logits [B, U, V] (f32)."""
        u, s = targets_in.shape[1], memory.shape[1]
        x = self.pos_enc(self._embed_scaled(targets_in))
        self_bias = mask_ops.mask_to_bias(
            mask_ops.self_attention_mask(tgt_lens, u, causal=True))
        cross_bias = mask_ops.mask_to_bias(
            mask_ops.padding_attention_mask(u, mem_lens, s))
        mem = memory.to(x.dtype)
        for layer in self.layers:
            x = layer(x, self_bias, mem, cross_bias)
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
