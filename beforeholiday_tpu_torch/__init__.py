"""beforeholiday_tpu_torch — the PyTorch/CUDA port of ``beforeholiday_tpu``
for NVIDIA Hopper (H100).

It mirrors the JAX package's module paths and is held against it by the
``tests/test_torch_*.py`` parity tests. Every TPU kernel on a ported path is
a hand-written Hopper kernel beside a plain PyTorch version of the same
function. Ported so far (slice 1, serving; slice 2, the O5 GPT training
step; slice 3, the O5 BERT + FusedLAMB pretraining step; slice 4, the
ImageNet ResNet-50 training step at O5 and O0 with FusedSGD; slice 5, the
unfused-attention GPT and BERT steps; slice 6, dropout; slice 7, the fused
label-smoothing cross entropy; slice 8, the rest of the optimizer family;
slice 11, the guarded data-parallel ResNet step; slice 13, amp O1-O4 and
the DCGAN example):

- ``beforeholiday_tpu_torch.ops``     — LayerNorm/RMSNorm forward and backward
  (kernels K1/K3, CUDA C++), flash attention forward and backward (K2/K4, CUDA
  C++), dense/MLP blocks, flat arenas, the unscale, fused-Adam, LAMB,
  global-norm and fused-SGD arena kernels (K5-K10, Triton), the scaled /
  masked / causal softmax family (K11/K12, Triton).
- ``beforeholiday_tpu_torch.contrib`` — ``softmax_cross_entropy_loss``, the
  fused label-smoothing cross entropy (kernels K14/K15, Triton).
- ``beforeholiday_tpu_torch.amp``     — opt levels O0-O5, device-side loss
  scaling, ``scaled_value_and_grad``, the O1/O4 autocast scope and tags,
  ``amp.functional``'s cast lists.
- ``beforeholiday_tpu_torch.optimizers`` — ``FusedAdam``, ``FusedLAMB``,
  ``FusedSGD``, ``MasterWeights`` and ``FusedMixedPrecisionLamb``.
- ``beforeholiday_tpu_torch.models``  — the ResNet family.
- ``beforeholiday_tpu_torch.parallel`` — process-group state, DDP (bucketed,
  compressed, backward-time hooks) over ``torch.distributed``, SyncBN, LARC.
- ``beforeholiday_tpu_torch.guard``   — ``StepGuard``, the device-side skip,
  sentinel and rollback state machine.
- ``beforeholiday_tpu_torch.tune``    — knob resolution (``UNSET``).
- ``beforeholiday_tpu_torch.examples.imagenet`` — the ImageNet ResNet
  trainer (``main_amp``); ``examples.dcgan`` — the multi-loss DCGAN.
- ``beforeholiday_tpu_torch.infer``   — paged KV cache (fp32, bf16, fp16 or
  e4m3 pages), bucketed inference engine, continuous batching, the radix
  prefix cache, prefill/decode disaggregation and serving telemetry;
  ``examples.serve`` — the async open-loop serving driver.
- ``beforeholiday_tpu_torch.monitor`` — device-side training metrics and
  their one-copy export, the memory and roofline ledgers, dispatch
  counters, spans, profiler traces and timers, the strict bucket-signature
  gate and its counters, the collective-traffic ledger, the host timeline
  (Perfetto export), overlap, straggler and goodput reports, latency
  histograms and the flight recorder.
- ``beforeholiday_tpu_torch.remat``   — named rematerialization policies
  (``remat.apply``) and their boundary tags.
- ``beforeholiday_tpu_torch.utils``   — rank-annotated logging, ``warn_once``.
- ``beforeholiday_tpu_torch.testing`` — the dense GPT and BERT (flash or
  unfused attention), their losses and batches, and fault injectors.
- ``beforeholiday_tpu_torch.transformer`` — the enums and
  ``functional.FusedScaleMaskSoftmax``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` or
hands them CPU tensors; with no card and no CPU request they raise.
"""

from beforeholiday_tpu_torch import (  # noqa: F401
    amp,
    contrib,
    guard,
    infer,
    models,
    monitor,
    ops,
    optimizers,
    parallel,
    remat,
    testing,
    transformer,
    tune,
    utils,
)

__version__ = "0.5.0"

__all__ = ["amp", "contrib", "guard", "infer", "models", "monitor", "ops",
           "optimizers", "parallel", "remat", "testing", "transformer", "tune",
           "utils"]
