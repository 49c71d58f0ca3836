"""Transformer building blocks of the PyTorch port (counterpart of
``mxnet_tpu/gluon/nn/transformer.py``): the full-sequence ``forward``
the training slice runs (attention through :func:`~..ops.nn.attend`,
flash attention with no mask and no training dropout), and the
incremental (KV-cache) paths the serving slice runs: ``forward_step``
over a dense per-request cache (prefill) and ``forward_step_paged`` over
a shared block pool (decode).

Caches and pools are written IN PLACE (the reference writes functional
copies, donated on the TPU); every method still returns them, so call
sites read like the reference's. The blocks are the port's Gluon
:class:`~..block.HybridBlock`s; their parameters are made by
``initialize()`` (``gpt_like`` calls it).
"""
from __future__ import annotations

import math

import torch

from ...autograd import is_training
from ...ops.nn import (attend, kv_cache_dequantize, kv_cache_quantize,
                       paged_attention, paged_attention_multi, paged_write)
from ..block import HybridBlock
from .basic_layers import Dense, Dropout
from .norm_layers import LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderLayer", "TransformerEncoder"]


class MultiHeadAttention(HybridBlock):
    """Self attention over (batch, seq, units) inputs: a (3U, U) ``qkv``
    projection and a (U, U) ``out_proj``."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 use_bias=True, dtype="float32"):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads {num_heads}")
        self._units = units
        self._heads = num_heads
        self._dropout = dropout
        self._causal = causal
        self.qkv = Dense(3 * units, use_bias=use_bias, flatten=False,
                         in_units=units, dtype=dtype)
        self.out_proj = Dense(units, use_bias=use_bias, flatten=False,
                              in_units=units, dtype=dtype)

    def forward(self, x, mask=None):
        """Self attention over the whole sequence ``x`` (B, L, units);
        dropout on the attention weights while training."""
        units = self._units
        p = self.qkv(x)
        out = attend(p[..., :units], p[..., units:2 * units],
                     p[..., 2 * units:], self._heads, causal=self._causal,
                     mask=mask, dropout=self._dropout,
                     training=is_training())
        return self.out_proj(out)

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
        T = 1 is the decode step; T > 1 serves speculative verify (K+1
        tokens per lane) and suffix prefill, through
        :func:`~..ops.nn.paged_attention_multi`.

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
        if t == 1:                      # the decode step
            out = paged_attention(q, pool_k, pool_v, bt, lengths)
        else:                           # speculative verify, suffix prefill
            out = paged_attention_multi(q.reshape(r, t, heads, d), pool_k,
                                        pool_v, block_table, positions)
        return self.out_proj(out.reshape(r, t, units)), pool_k, pool_v

    def _forward_step_paged_fused(self, x, pool_k, pool_v, block_table,
                                  positions):
        """:meth:`forward_step_paged` through K5a -> pool write -> K4 ->
        K5b (:func:`~..ops.kernels.fused_decode.fused_decode_step`)."""
        from ...ops.kernels.fused_decode import fused_decode_step

        return fused_decode_step(
            x, self.qkv.weight.data(), self.qkv.bias.data(),
            self.out_proj.weight.data(), self.out_proj.bias.data(), pool_k,
            pool_v, block_table, positions,
            heads=self._heads, units=self._units)


class PositionwiseFFN(HybridBlock):
    """FFN(x) = W2 act(W1 x + b1) + b2."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 dtype="float32"):
        super().__init__()
        self.ffn_1 = Dense(hidden_size, flatten=False, in_units=units,
                           activation=activation, dtype=dtype)
        self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                           dtype=dtype)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        h = self.ffn_1(x)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ffn_2(h)


class TransformerEncoderLayer(HybridBlock):
    """Self-attention + FFN block, pre-LN (default) or post-LN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="gelu", causal=False,
                 pre_norm=True, dtype="float32"):
        super().__init__()
        self._pre_norm = pre_norm
        self.attn = MultiHeadAttention(units, num_heads,
                                       dropout=attention_dropout,
                                       causal=causal, dtype=dtype)
        self.ffn = PositionwiseFFN(units, hidden_size, activation=activation,
                                   dropout=dropout, dtype=dtype)
        self.ln1 = LayerNorm(in_channels=units, dtype=dtype)
        self.ln2 = LayerNorm(in_channels=units, dtype=dtype)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        """Full-sequence step; dropout after attention and after the FFN
        while training."""
        drop = self.dropout if self.dropout is not None else (lambda h: h)
        if self._pre_norm:
            x = x + drop(self.attn(self.ln1(x), mask=mask))
            return x + drop(self.ffn(self.ln2(x)))
        x = self.ln1(x + drop(self.attn(x, mask=mask)))
        return self.ln2(x + drop(self.ffn(x)))

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


class TransformerEncoder(HybridBlock):
    """Stack of ``num_layers`` encoder layers (``layer0`` ...) and, for
    pre-norm stacks, a ``final_ln``."""

    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="gelu", causal=False,
                 pre_norm=True, dtype="float32"):
        super().__init__()
        self._num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", TransformerEncoderLayer(
                units, hidden_size, num_heads, dropout=dropout,
                attention_dropout=attention_dropout, activation=activation,
                causal=causal, pre_norm=pre_norm, dtype=dtype))
        self.final_ln = (LayerNorm(in_channels=units, dtype=dtype)
                         if pre_norm else None)

    def forward(self, x, mask=None):
        """Full-sequence forward through the stack."""
        for i in range(self._num_layers):
            x = getattr(self, f"layer{i}")(x, mask=mask)
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x

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
