"""Decoder-only LM of the PyTorch port (counterpart of ``_CausalLM`` and
``gpt_like`` in ``mxnet_tpu/gluon/model_zoo/bert.py``).

Attribute names are the reference's, so ``state_dict()`` keys are
exactly its ``collect_params()`` names (``word_embed.weight``,
``pos_embed``, ``encoder.layer0.attn.qkv.weight``, ...,
``encoder.final_ln.gamma``) and :func:`~mxnet_tpu_torch.convert.from_jax_params`
is a checked ``load_state_dict``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops.nn import _KV_SCALE_BYTES
from .. import nn as gnn
from ..nn.basic_layers import _dtype
from ..nn.transformer import TransformerEncoder

__all__ = ["gpt_like"]


class _CausalLM(nn.Module):
    """GPT-style LM: word + learned position embeddings, a causal pre-norm
    transformer stack, and an LM head tied to the word embedding."""

    def __init__(self, vocab_size=32000, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=2048,
                 dropout=0.0, dtype="float32", device=None):
        super().__init__()
        self._units = units
        self.word_embed = gnn.Embedding(vocab_size, units, dtype=dtype,
                                        device=device)
        self.pos_embed = nn.Parameter(
            torch.empty((max_length, units), dtype=_dtype(dtype),
                        device=device).normal_(0.0, 0.02))
        self.encoder = TransformerEncoder(
            num_layers, units, hidden_size, num_heads, dropout=dropout,
            attention_dropout=dropout, causal=True, pre_norm=True,
            dtype=dtype, device=device)

    @property
    def vocab_size(self) -> int:
        return self.word_embed.weight.shape[0]

    def _head(self, seq):
        return torch.matmul(seq, self.word_embed.weight.t())

    def decode_step(self, token_ids, cache_k, cache_v, pos: int):
        """KV-cache forward of ``token_ids`` (B, T) at absolute positions
        [pos, pos+T). Returns (logits (B, T, V), cache_k, cache_v), the
        caches written in place. Used by
        :func:`~mxnet_tpu_torch.gluon.model_zoo.generation.generate` and
        the serving engine's prefill."""
        t = token_ids.shape[1]
        rows = self.pos_embed.shape[0]
        if pos < 0 or pos + t > rows:
            # the reference's dynamic_slice would clamp the start and
            # silently reuse other rows: an error here
            raise MXNetError(
                f"positions [{pos}, {pos + t}) exceed the model's context "
                f"window (max_length={rows})")
        emb = self.word_embed(token_ids) + self.pos_embed[pos:pos + t][None]
        seq, ck, cv = self.encoder.forward_step(emb, cache_k, cache_v, pos)
        return self._head(seq), ck, cv

    def decode_step_paged(self, token_ids, pool_k, pool_v, block_table,
                          positions):
        """Paged-KV decode of T tokens per lane: ``token_ids`` (R, T),
        lane ``r``'s token ``t`` at absolute position ``positions[r] + t``;
        K/V land in the shared block pools through ``block_table``
        (R, MB). Returns (logits (R, T, V), pool_k, pool_v). Positions are
        bounded by the caller (the engine checks them on the host): an
        out-of-range position is a device-side assert on the card."""
        t = token_ids.shape[1]
        idx = (positions.long()[:, None]
               + torch.arange(t, device=token_ids.device)[None])
        emb = self.word_embed(token_ids) + self.pos_embed[idx]
        seq, pk, pv = self.encoder.forward_step_paged(
            emb, pool_k, pool_v, block_table, positions)
        return self._head(seq), pk, pv

    def _kv_shape(self, lead, dtype):
        enc = self.encoder
        heads = enc.layer0.attn._heads
        d = enc.layer0.attn._units // heads
        if dtype == "int8":
            d += _KV_SCALE_BYTES
        return (enc._num_layers, *lead, heads, d)

    def _zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=_dtype(dtype),
                           device=self.word_embed.weight.device)

    def init_block_pool(self, num_blocks, block_size, dtype="float32"):
        """Zeroed (L, NB, H, block_size, D') paged K/V block pools
        (``D' = D + 4`` for int8: values + the bitcast f32 scale)."""
        shape = self._kv_shape((num_blocks,), dtype)
        shape = shape[:3] + (block_size,) + shape[3:]
        return self._zeros(shape, dtype), self._zeros(shape, dtype)

    def init_cache(self, batch_size, max_length, dtype="float32"):
        """Zeroed (L, B, H, Lmax, D') dense key/value caches."""
        shape = self._kv_shape((batch_size,), dtype)
        shape = shape[:3] + (max_length,) + shape[3:]
        return self._zeros(shape, dtype), self._zeros(shape, dtype)


def gpt_like(device=None, **kwargs):
    """A :class:`_CausalLM` on ``device`` (default ``gpu(0)``; raises
    when no card is available and ``device="cpu"`` was not asked for)."""
    return _CausalLM(device=resolve_device(device), **kwargs)
