"""Serving stack of the PyTorch port."""
from .admission import (AdmissionQueue, DeadlineExceeded, Request,
                        RequestCancelled, ServerOverload)
from .kv_hash import chain_hashes, hash_hex, prefix_key
from .llm import GenRequest, LLMEngine

__all__ = ["AdmissionQueue", "DeadlineExceeded", "Request",
           "RequestCancelled", "ServerOverload", "GenRequest", "LLMEngine",
           "chain_hashes", "prefix_key", "hash_hex"]
