"""Serving stack of the PyTorch port."""
from .admission import (AdmissionQueue, DeadlineExceeded, Request,
                        RequestCancelled, ServerOverload)
from .kv_hash import chain_hashes, hash_hex, prefix_key
from .kv_spill import KVSpillTier
from .llm import GenRequest, LLMEngine, LLMMetrics

__all__ = ["AdmissionQueue", "DeadlineExceeded", "Request",
           "RequestCancelled", "ServerOverload", "GenRequest", "LLMEngine",
           "LLMMetrics", "KVSpillTier",
           "chain_hashes", "prefix_key", "hash_hex"]
