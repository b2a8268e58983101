"""Serving — bucketed prefill/decode over a paged KV cache with continuous
batching (counterpart of ``beforeholiday_tpu/infer``).

* :mod:`~beforeholiday_tpu_torch.infer.kvcache` — paged KV cache (fp32,
  bf16, fp16 or e4m3 pages carved from one flat buffer, e4m3 under per-page
  scales, page 0 the null page) and the refcounting page allocator.
* :mod:`~beforeholiday_tpu_torch.infer.engine` — bucketed prefill and
  single-token decode behind the strict bucket gate.
* :mod:`~beforeholiday_tpu_torch.infer.batching` — continuous batching with
  preemption by recompute, the optional prefix cache, and the
  static-batching baseline.
* :mod:`~beforeholiday_tpu_torch.infer.radix` — host-side radix tree over
  page-aligned token prefixes: shared prompt prefixes alias shared KV pages
  (refcounted, copy-on-write tails).
* :mod:`~beforeholiday_tpu_torch.infer.disagg` — prefill/decode
  disaggregation: separate bucket sets per regime, a page-table handoff,
  decode-priority scheduling.
* :mod:`~beforeholiday_tpu_torch.infer.telemetry` — per-request lifecycle
  records, mergeable latency histograms, Perfetto request and counter
  tracks, and SLO burn-rate gates wired to the flight recorder.

The async open-loop request driver lives in
``beforeholiday_tpu_torch/examples/serve/``.
"""

from beforeholiday_tpu_torch.infer.batching import (  # noqa: F401
    ContinuousBatcher,
    Request,
    static_batched_generate,
)
from beforeholiday_tpu_torch.infer.disagg import (  # noqa: F401
    DisaggregatedBatcher,
)
from beforeholiday_tpu_torch.infer.engine import (  # noqa: F401
    EngineConfig,
    InferenceEngine,
    pick_bucket,
)
from beforeholiday_tpu_torch.infer.radix import (  # noqa: F401
    RadixCache,
)
from beforeholiday_tpu_torch.infer.telemetry import (  # noqa: F401
    RequestRecord,
    ServingTelemetry,
    SLOPolicy,
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
    "DisaggregatedBatcher",
    "EngineConfig",
    "InferenceEngine",
    "KVCache",
    "NULL_PAGE",
    "PageAllocator",
    "PagedLayout",
    "RadixCache",
    "Request",
    "RequestRecord",
    "SLOPolicy",
    "ServingTelemetry",
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
