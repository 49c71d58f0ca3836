"""BERT and the decoder-only LM of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/bert.py``).

Attribute names are the reference's, so ``state_dict()`` keys are
exactly its ``collect_params()`` names (``word_embed.weight``,
``pos_embed``, ``encoder.layer0.attn.qkv.weight``, ...), which
:func:`~mxnet_tpu_torch.convert.from_jax_params` loads by name.

- :class:`BERTModel` (``bert_base``, ``bert_large``) and
  :class:`BERTForPretraining` follow the reference's contract: their
  parameters are made by ``initialize()`` (on ``gpu(0)`` unless a device
  is given) or ``load_parameters``. The encoder is post-norm and not
  causal; without ``valid_length`` and without training dropout its
  attention runs the K1 kernels, with ``valid_length`` the masked plain
  path, as the reference's does. The MLM decoder is tied to the word
  embedding.
- ``gpt_like`` returns the causal LM initialized on its device (weights
  N(0, 0.02) from the port's generator, LayerNorm gains 1, biases 0),
  ready to load weights into or to run.
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError, dtype_from_any
from ...context import resolve_device
from ...initializer import Normal
from ...ops.nn import _KV_SCALE_BYTES
from .. import nn as gnn
from ..block import HybridBlock
from ..nn.transformer import TransformerEncoder
from ..parameter import Parameter

__all__ = ["BERTModel", "BERTForPretraining", "bert_base", "bert_large",
           "gpt_like"]


class BERTModel(HybridBlock):
    """Word, position and token-type embeddings, LayerNorm, a post-norm
    transformer encoder and a tanh pooler over the first token. Returns
    (sequence output (B, L, units), pooled output (B, units))."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_types=2, dropout=0.1, tp_axis=None,
                 dtype="float32"):
        super().__init__()
        if tp_axis is not None:
            raise MXNetError(
                f"tp_axis={tp_axis!r}: tensor parallelism is not ported "
                "(ROADMAP section 1 item 8, parallel and distributed)")
        self._units = units
        self.word_embed = gnn.Embedding(vocab_size, units, dtype=dtype)
        self.token_type_embed = gnn.Embedding(token_types, units,
                                              dtype=dtype)
        self.pos_embed = Parameter("pos_embed", shape=(max_length, units),
                                   dtype=dtype)
        self.embed_ln = gnn.LayerNorm(in_channels=units)
        self.embed_dropout = gnn.Dropout(dropout) if dropout else None
        self.encoder = TransformerEncoder(
            num_layers, units, hidden_size, num_heads, dropout=dropout,
            attention_dropout=dropout, pre_norm=False, dtype=dtype)
        self.pooler = gnn.Dense(units, activation="tanh", flatten=False,
                                in_units=units, dtype=dtype)

    def forward(self, token_ids, token_types=None, valid_length=None):
        """``token_ids`` (B, L); ``token_types`` (B, L) or None;
        ``valid_length`` (B,): keys at positions >= it are masked out."""
        l = token_ids.shape[1]
        pos = self.pos_embed.data()
        if l > pos.shape[0]:
            raise MXNetError(f"sequence length {l} exceeds the model's "
                             f"max_length {pos.shape[0]}")
        emb = self.word_embed(token_ids)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        emb = self.embed_ln(emb + pos[:l])
        if self.embed_dropout is not None:
            emb = self.embed_dropout(emb)
        mask = None
        if valid_length is not None:
            vl = torch.as_tensor(valid_length, device=emb.device)
            keep = torch.arange(l, device=emb.device)[None, :] < vl[:, None]
            mask = keep[:, None, None, :]              # (B, 1, 1, Lk) bool
        seq = self.encoder(emb, mask=mask)
        return seq, self.pooler(seq[:, 0])


class BERTForPretraining(HybridBlock):
    """A :class:`BERTModel` with the masked-LM head (a gelu Dense,
    LayerNorm, and a decoder tied to the word embedding plus
    ``mlm_bias``) and the next-sentence head ``nsp``. Returns (MLM
    logits (B, L, vocab), NSP logits (B, 2))."""

    def __init__(self, bert: BERTModel, vocab_size=30522, dtype="float32"):
        super().__init__()
        self.bert = bert
        units = bert._units
        self.mlm_transform = gnn.Dense(units, activation="gelu",
                                       flatten=False, in_units=units,
                                       dtype=dtype)
        self.mlm_ln = gnn.LayerNorm(in_channels=units)
        self.mlm_bias = Parameter("mlm_bias", shape=(vocab_size,),
                                  dtype=dtype, init="zeros")
        self.nsp = gnn.Dense(2, flatten=False, in_units=units, dtype=dtype)

    def forward(self, token_ids, token_types=None, valid_length=None):
        seq, pooled = self.bert(token_ids, token_types, valid_length)
        h = self.mlm_ln(self.mlm_transform(seq))
        w = self.bert.word_embed.weight.data()
        logits = torch.matmul(h, w.t()) + self.mlm_bias.data()
        return logits, self.nsp(pooled)


def bert_base(**kwargs):
    """BERT-base: 12 layers, units 768, hidden 3072, 12 heads (the
    reference's ``BASELINE.json`` configuration); ``kwargs`` override."""
    cfg = dict(units=768, hidden_size=3072, num_layers=12, num_heads=12)
    cfg.update(kwargs)
    return BERTModel(**cfg)


def bert_large(**kwargs):
    """BERT-large: 24 layers, units 1024, hidden 4096, 16 heads."""
    cfg = dict(units=1024, hidden_size=4096, num_layers=24, num_heads=16)
    cfg.update(kwargs)
    return BERTModel(**cfg)


class _CausalLM(HybridBlock):
    """GPT-style LM: word + learned position embeddings, a causal pre-norm
    transformer stack, and an LM head tied to the word embedding. Its
    parameters are initialized on ``device`` at construction (``pos_embed``
    is a torch ``nn.Parameter``, collected like the others)."""

    def __init__(self, vocab_size=32000, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=2048,
                 dropout=0.0, dtype="float32", device=None):
        super().__init__()
        self._units = units
        device = resolve_device(device)
        init = Normal(0.02)
        self.word_embed = gnn.Embedding(vocab_size, units, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(
            (max_length, units), dtype=dtype_from_any(dtype), device=device))
        init.init_array("pos_embed", self.pos_embed)
        self.encoder = TransformerEncoder(
            num_layers, units, hidden_size, num_heads, dropout=dropout,
            attention_dropout=dropout, causal=True, pre_norm=True,
            dtype=dtype)
        self.initialize(init, device=device)

    @property
    def vocab_size(self) -> int:
        return self.word_embed.weight.shape[0]

    def _pos(self):
        """``pos_embed`` as a layer reads its weight, through its
        Parameter's ``data()``, so that
        :func:`~mxnet_tpu_torch.gluon.parameter.substituted` reaches it
        on the calling thread."""
        return self.params["pos_embed"].data()

    def _head(self, seq):
        return torch.matmul(seq, self.word_embed.weight.data().t())

    def forward(self, token_ids):
        """Logits (B, L, V) of ``token_ids`` (B, L) at positions [0, L):
        the training forward, causal flash attention in every layer."""
        l = token_ids.shape[1]
        rows = self.pos_embed.shape[0]
        if l > rows:
            # the reference's pos_embed[:l] then fails to broadcast
            raise MXNetError(f"sequence length {l} exceeds the model's "
                             f"context window (max_length={rows})")
        emb = self.word_embed(token_ids) + self._pos()[:l][None]
        return self._head(self.encoder(emb))

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
        emb = self.word_embed(token_ids) + self._pos()[pos:pos + t][None]
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
        emb = self.word_embed(token_ids) + self._pos()[idx]
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
        return torch.zeros(shape, dtype=dtype_from_any(dtype),
                           device=self.word_embed.weight.data().device)

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
