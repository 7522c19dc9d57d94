from repro_torch.serve.cache import PagedCachePool, PrefixCache
from repro_torch.serve.engine import Engine, Request, ServeStats
from repro_torch.serve.scheduler import (Scheduler, decode_widths_for,
                                         prompt_buckets_for)

__all__ = ["Engine", "Request", "ServeStats", "Scheduler", "PagedCachePool",
           "PrefixCache", "decode_widths_for", "prompt_buckets_for"]
