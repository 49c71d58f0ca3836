"""Serving stack of the PyTorch port."""
from .admission import (AdmissionQueue, DeadlineExceeded, Request,
                        RequestCancelled, ServerOverload)
from .llm import GenRequest, LLMEngine

__all__ = ["AdmissionQueue", "DeadlineExceeded", "Request",
           "RequestCancelled", "ServerOverload", "GenRequest", "LLMEngine"]
