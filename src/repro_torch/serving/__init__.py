"""Continuous-batching serving engine of the port (dense and ssm
families, one device): host-side page bookkeeping and scheduler (own
copies of the JAX package's), the sampler, and ``ContinuousEngine``."""
from .engine import ContinuousEngine
from .kv_cache import PageAllocator, PagedCacheState, pages_needed
from .sampling import SamplingParams, sample_tokens
from .scheduler import PrefixIndex, Request, Scheduler, SequenceState

__all__ = ["ContinuousEngine", "PageAllocator", "PagedCacheState",
           "PrefixIndex", "pages_needed", "Request", "SamplingParams",
           "sample_tokens", "Scheduler", "SequenceState"]
