"""Serving — bucketed prefill/decode over a paged KV cache with continuous
batching (counterpart of ``beforeholiday_tpu/infer``).

* :mod:`~beforeholiday_tpu_torch.infer.kvcache` — paged KV cache (fp32 or
  e4m3 pages carved from one flat buffer, e4m3 under per-page scales, page 0
  the null page) and the page allocator.
* :mod:`~beforeholiday_tpu_torch.infer.engine` — bucketed prefill and
  single-token decode behind the strict bucket gate.
* :mod:`~beforeholiday_tpu_torch.infer.batching` — continuous batching with
  preemption by recompute, and the static-batching baseline.

The radix prefix cache, disaggregation and telemetry are not ported yet.
"""

from beforeholiday_tpu_torch.infer.batching import (  # noqa: F401
    ContinuousBatcher,
    Request,
    static_batched_generate,
)
from beforeholiday_tpu_torch.infer.engine import (  # noqa: F401
    EngineConfig,
    InferenceEngine,
    pick_bucket,
)
from beforeholiday_tpu_torch.infer.kvcache import (  # noqa: F401
    KVCache,
    NULL_PAGE,
    PageAllocator,
    PagedLayout,
    alloc_cache,
    gather_pages,
    gather_pages_quantized,
    kv_dequant_error_bound,
    kv_logit_error_bound,
    pages_for,
    write_prefill,
    write_prefill_quantized,
    write_token,
    write_token_quantized,
)

__all__ = [
    "ContinuousBatcher",
    "EngineConfig",
    "InferenceEngine",
    "KVCache",
    "NULL_PAGE",
    "PageAllocator",
    "PagedLayout",
    "Request",
    "alloc_cache",
    "gather_pages",
    "gather_pages_quantized",
    "kv_dequant_error_bound",
    "kv_logit_error_bound",
    "pages_for",
    "pick_bucket",
    "static_batched_generate",
    "write_prefill",
    "write_prefill_quantized",
    "write_token",
    "write_token_quantized",
]
