"""Transformer building blocks of the PyTorch port (counterpart of
``mxnet_tpu/gluon/nn/transformer.py``), limited to the incremental
(KV-cache) paths the serving slice runs: ``forward_step`` over a dense
per-request cache (prefill) and ``forward_step_paged`` over a shared
block pool (decode). The non-incremental ``forward`` goes through flash
attention and belongs to the training slice.

Caches and pools are written IN PLACE (the reference writes functional
copies, donated on the TPU); every method still returns them, so call
sites read like the reference's.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.nn import (kv_cache_dequantize, kv_cache_quantize,
                       paged_attention, paged_write)
from .basic_layers import Dense, Dropout
from .norm_layers import LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderLayer", "TransformerEncoder"]


class MultiHeadAttention(nn.Module):
    """Self attention over (batch, seq, units) inputs: a (3U, U) ``qkv``
    projection and a (U, U) ``out_proj``."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 use_bias=True, dtype="float32", device=None):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads {num_heads}")
        self._units = units
        self._heads = num_heads
        self._dropout = dropout
        self._causal = causal
        self.qkv = Dense(3 * units, use_bias=use_bias, flatten=False,
                         in_units=units, dtype=dtype, device=device)
        self.out_proj = Dense(units, use_bias=use_bias, flatten=False,
                              in_units=units, dtype=dtype, device=device)

    def forward_step(self, x, cache_k, cache_v, pos: int):
        """Incremental attention: ``x`` is (B, T, units) at absolute
        positions [pos, pos+T); caches are (B, H, Lmax, D') written in
        place. T = prompt length for prefill, 1 for decode. Returns
        (out, cache_k, cache_v)."""
        units, heads = self._units, self._heads
        p = self.qkv(x)
        b, t, _ = p.shape
        d = units // heads

        def split_heads(c):             # (B, T, U) -> (B, H, T, D)
            return c.reshape(b, t, heads, d).permute(0, 2, 1, 3)

        q = split_heads(p[..., :units])
        k = split_heads(p[..., units:2 * units])
        v = split_heads(p[..., 2 * units:])
        quantized = cache_k.dtype == torch.int8
        if quantized:
            k_store, v_store = kv_cache_quantize(k), kv_cache_quantize(v)
        else:
            k_store, v_store = k.to(cache_k.dtype), v.to(cache_v.dtype)
        cache_k[:, :, pos:pos + t] = k_store
        cache_v[:, :, pos:pos + t] = v_store
        if quantized:                   # int8 rides memory; math in q's dtype
            keys = kv_cache_dequantize(cache_k, q.dtype)
            vals = kv_cache_dequantize(cache_v, q.dtype)
        else:
            keys, vals = cache_k, cache_v
        lmax = cache_k.shape[2]
        ct = torch.promote_types(q.dtype, keys.dtype)
        scores = torch.einsum("bhtd,bhld->bhtl", q.to(ct),
                              keys.to(ct)).float()
        scores = scores / math.sqrt(d)
        col = torch.arange(lmax, device=x.device)[None, None, None, :]
        row = pos + torch.arange(t, device=x.device)[None, None, :, None]
        scores = torch.where(col <= row, scores,
                             torch.full_like(scores, float("-inf")))
        attn = torch.softmax(scores, dim=-1).to(vals.dtype)
        out = torch.einsum("bhtl,bhld->bhtd", attn, vals)
        out = out.permute(0, 2, 1, 3).reshape(b, t, units)
        return self.out_proj(out), cache_k, cache_v

    def forward_step_paged(self, x, pool_k, pool_v, block_table, positions):
        """Paged-KV decode attention: ``x`` is (R, T, units), lane ``r``'s
        token ``t`` at absolute position ``positions[r] + t``; its K/V are
        written in place into the pools (NB, H, bs, D') of THIS layer at
        ``block_table[r, p // bs]`` slot ``p % bs``, then attended through
        the table as R*T virtual lanes whose lengths are the causal mask.

        When :func:`~..ops.kernels.fused_decode.fused_decode_armed` arms
        (CUDA tensors by default), the QKV projection with the KV store
        conversion and the out projection run as the K5a / K5b kernels
        around K4 (:meth:`_forward_step_paged_fused`)."""
        from ...ops.kernels import fused_decode as _fused

        if _fused.fused_decode_armed(x.device):
            return self._forward_step_paged_fused(
                x, pool_k, pool_v, block_table, positions)
        units, heads = self._units, self._heads
        p = self.qkv(x)
        r, t = p.shape[0], p.shape[1]
        d = units // heads

        def split(c):                   # (R, T, U) -> (R*T, H, D)
            return c.reshape(r * t, heads, d)

        q = split(p[..., :units]).contiguous()
        k = split(p[..., units:2 * units])
        v = split(p[..., 2 * units:])
        if pool_k.dtype == torch.int8:
            k_store, v_store = kv_cache_quantize(k), kv_cache_quantize(v)
        else:
            k_store, v_store = k.to(pool_k.dtype), v.to(pool_v.dtype)
        bt, lengths = paged_write(pool_k, pool_v, k_store, v_store,
                                  block_table, positions)
        out = paged_attention(q, pool_k, pool_v, bt, lengths)
        return self.out_proj(out.reshape(r, t, units)), pool_k, pool_v

    def _forward_step_paged_fused(self, x, pool_k, pool_v, block_table,
                                  positions):
        """:meth:`forward_step_paged` through K5a -> pool write -> K4 ->
        K5b (:func:`~..ops.kernels.fused_decode.fused_decode_step`)."""
        from ...ops.kernels.fused_decode import fused_decode_step

        return fused_decode_step(
            x, self.qkv.weight, self.qkv.bias, self.out_proj.weight,
            self.out_proj.bias, pool_k, pool_v, block_table, positions,
            heads=self._heads, units=self._units)


class PositionwiseFFN(nn.Module):
    """FFN(x) = W2 act(W1 x + b1) + b2."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 dtype="float32", device=None):
        super().__init__()
        self.ffn_1 = Dense(hidden_size, flatten=False, in_units=units,
                           activation=activation, dtype=dtype, device=device)
        self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                           dtype=dtype, device=device)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        h = self.ffn_1(x)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ffn_2(h)


class TransformerEncoderLayer(nn.Module):
    """Self-attention + FFN block, pre-LN (default) or post-LN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="gelu", causal=False,
                 pre_norm=True, dtype="float32", device=None):
        super().__init__()
        self._pre_norm = pre_norm
        self.attn = MultiHeadAttention(units, num_heads,
                                       dropout=attention_dropout,
                                       causal=causal, dtype=dtype,
                                       device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, activation=activation,
                                   dropout=dropout, dtype=dtype, device=device)
        self.ln1 = LayerNorm(in_channels=units, dtype=dtype, device=device)
        self.ln2 = LayerNorm(in_channels=units, dtype=dtype, device=device)
        self.dropout = Dropout(dropout) if dropout else None

    def forward_step(self, x, cache_k, cache_v, pos: int):
        """KV-cache step (no dropout: decode is inference)."""
        if self._pre_norm:
            h, ck, cv = self.attn.forward_step(self.ln1(x), cache_k,
                                               cache_v, pos)
            x = x + h
            return x + self.ffn(self.ln2(x)), ck, cv
        h, ck, cv = self.attn.forward_step(x, cache_k, cache_v, pos)
        x = self.ln1(x + h)
        return self.ln2(x + self.ffn(x)), ck, cv

    def forward_step_paged(self, x, pool_k, pool_v, block_table, positions):
        """Paged-pool variant of :meth:`forward_step`."""
        if self._pre_norm:
            h, pk, pv = self.attn.forward_step_paged(
                self.ln1(x), pool_k, pool_v, block_table, positions)
            x = x + h
            return x + self.ffn(self.ln2(x)), pk, pv
        h, pk, pv = self.attn.forward_step_paged(
            x, pool_k, pool_v, block_table, positions)
        x = self.ln1(x + h)
        return self.ln2(x + self.ffn(x)), pk, pv


class TransformerEncoder(nn.Module):
    """Stack of ``num_layers`` encoder layers (``layer0`` ...) and, for
    pre-norm stacks, a ``final_ln``."""

    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="gelu", causal=False,
                 pre_norm=True, dtype="float32", device=None):
        super().__init__()
        self._num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", TransformerEncoderLayer(
                units, hidden_size, num_heads, dropout=dropout,
                attention_dropout=attention_dropout, activation=activation,
                causal=causal, pre_norm=pre_norm, dtype=dtype,
                device=device))
        self.final_ln = (LayerNorm(in_channels=units, dtype=dtype,
                                   device=device) if pre_norm else None)

    def forward_step(self, x, cache_k, cache_v, pos: int):
        """KV-cache step through the stack; caches are
        (num_layers, B, H, Lmax, D') and layer ``i`` writes slice ``i``."""
        for i in range(self._num_layers):
            x, _, _ = getattr(self, f"layer{i}").forward_step(
                x, cache_k[i], cache_v[i], pos)
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x, cache_k, cache_v

    def forward_step_paged(self, x, pool_k, pool_v, block_table, positions):
        """Paged decode through the stack; pools are
        (num_layers, NB, H, bs, D') sharing ONE block table (a block id
        addresses every layer's pool)."""
        for i in range(self._num_layers):
            x, _, _ = getattr(self, f"layer{i}").forward_step_paged(
                x, pool_k[i], pool_v[i], block_table, positions)
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x, pool_k, pool_v
