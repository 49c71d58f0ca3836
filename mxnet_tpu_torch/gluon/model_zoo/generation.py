"""Autoregressive generation of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/generation.py``).

PyTorch runs eagerly, so where the reference builds and memoizes jitted
programs these are plain functions: :func:`generate` is the dense-cache
offline oracle, and :func:`paged_decode_program` /
:func:`paged_prefill_program` return the two step functions the serving
engine calls (one decode step over the whole lane set, one
prefill-and-splice per prompt bucket). Sampling draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import numpy as onp
import torch

from ...base import MXNetError
from ...context import resolve_device

__all__ = ["generate", "paged_decode_program", "paged_prefill_program"]

_KV_CACHE_DTYPES = (None, "int8", "float32", "bfloat16", "float16")


def _sample(logits, generator, greedy, temperature, top_k):
    """Pick next tokens (int32) from (B, V) logits."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, float("-inf")), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _resolve_cache_dtype(model, kv_cache_dtype):
    """Validate + default the KV cache dtype (the model's dtype)."""
    if kv_cache_dtype not in _KV_CACHE_DTYPES:
        raise MXNetError(
            f"kv_cache_dtype {kv_cache_dtype!r} not supported "
            "(int8/float32/bfloat16/float16)")
    return kv_cache_dtype or str(model.word_embed.weight.dtype).replace(
        "torch.", "")


def _model_device(model, device):
    """The device an entry point runs on; the model must already be
    there (no silent moves of the caller's weights)."""
    dev = resolve_device(device)
    have = model.word_embed.weight.device
    if have.type != dev.type or (dev.type == "cuda"
                                 and have.index != dev.index):
        raise MXNetError(
            f"model parameters are on {have}, the entry point runs on "
            f"{dev}: move the model with model.to({str(dev)!r}) or pass "
            f"device={str(have)!r}")
    return dev


def generate(model, prompt_ids, max_new_tokens: int,
             max_length: Optional[int] = None, greedy: bool = True,
             temperature: float = 1.0, top_k: int = 0, eos_token: int = -1,
             seed: int = 0, kv_cache_dtype: Optional[str] = None,
             device=None):
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` (B, P)
    through a dense per-batch KV cache. Returns a (B, max_new_tokens)
    int32 tensor on the model's device. Once a sequence emits
    ``eos_token``, its remaining positions repeat it."""
    dev = _model_device(model, device)
    if isinstance(prompt_ids, torch.Tensor):
        prompt = prompt_ids.to(device=dev, dtype=torch.int32)
    else:
        prompt = torch.as_tensor(onp.asarray(prompt_ids, onp.int32),
                                 device=dev)
    b, p = prompt.shape
    lmax = max_length or (p + max_new_tokens)
    if lmax < p + max_new_tokens:
        raise MXNetError(f"max_length {lmax} < prompt {p} + max_new_tokens "
                         f"{max_new_tokens}")
    rows = model.pos_embed.shape[0]
    if lmax > rows:
        raise MXNetError(f"generation length {lmax} exceeds the model's "
                         f"context window (max_length={rows})")
    ck, cv = model.init_cache(b, lmax,
                              dtype=_resolve_cache_dtype(model, kv_cache_dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        logits, ck, cv = model.decode_step(prompt, ck, cv, 0)
        tok = _sample(logits[:, -1], gen, greedy, temperature, top_k)
        done = tok == eos_token
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, ck, cv = model.decode_step(tok[:, None], ck, cv, p + i)
            nxt = _sample(logits[:, -1], gen, greedy, temperature, top_k)
            nxt = torch.where(done, torch.full_like(nxt, eos_token), nxt)
            done = done | (nxt == eos_token)
            out.append(nxt)
            tok = nxt
    return torch.stack(out, dim=1)


def paged_decode_program(model, *, greedy=True, temperature=1.0, top_k=0):
    """The continuous-batching decode step over the whole lane set.

    Returns ``run(tokens (R, 1) i32, pool_k, pool_v, block_table (R, MB)
    i32, positions (R,) i32, generator) -> (next_tokens (R,) i32, pool_k,
    pool_v)``, all tensors on the model's device. Lane ``r``'s token is
    written at ``positions[r]`` through its table row (pools updated in
    place), attended through the pool, and sampled. Inactive lanes point
    at a trash block; their outputs are ignored by the scheduler."""

    def run(tokens, pool_k, pool_v, block_table, positions, generator):
        with torch.no_grad():
            logits, pool_k, pool_v = model.decode_step_paged(
                tokens, pool_k, pool_v, block_table, positions)
            nxt = _sample(logits[:, -1], generator, greedy, temperature,
                          top_k)
        return nxt, pool_k, pool_v

    return run


def paged_prefill_program(model, *, prefill_len, block_size,
                          kv_cache_dtype=None, greedy=True, temperature=1.0,
                          top_k=0):
    """The prefill-and-splice step for one prompt-length bucket.

    Returns ``run(prompt (1, Pb) i32, last_idx int, pool_k, pool_v,
    block_ids (Pb//bs,) i64, generator) -> (first_token () i32, pool_k,
    pool_v)``. The prompt (padded to the bucket ``Pb``) fills a dense
    cache, which is cut into ``Pb // block_size`` blocks and written into
    the pools at ``block_ids`` in place (ids past the prompt's real
    blocks point at the trash block, which may repeat); the first token
    is sampled from the logits at ``last_idx``, the last real prompt
    position."""
    cache_dtype = _resolve_cache_dtype(model, kv_cache_dtype)
    pb, bs = int(prefill_len), int(block_size)
    if pb % bs:
        raise MXNetError(
            f"prefill bucket {pb} must be a multiple of block_size {bs}")
    nb = pb // bs

    def run(prompt, last_idx, pool_k, pool_v, block_ids, generator):
        with torch.no_grad():
            ck, cv = model.init_cache(1, pb, dtype=cache_dtype)
            logits, ck, cv = model.decode_step(prompt, ck, cv, 0)
            lyr, _, heads, _, dp = ck.shape

            def blocks(c):              # (L,1,H,Pb,D') -> (L,nb,H,bs,D')
                return c[:, 0].reshape(lyr, heads, nb, bs, dp).permute(
                    0, 2, 1, 3, 4)

            pool_k[:, block_ids] = blocks(ck)
            pool_v[:, block_ids] = blocks(cv)
            first = _sample(logits[:, last_idx], generator, greedy,
                            temperature, top_k)[0]
        return first, pool_k, pool_v

    return run
