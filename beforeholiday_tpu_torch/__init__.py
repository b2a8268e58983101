"""beforeholiday_tpu_torch — the PyTorch/CUDA port of ``beforeholiday_tpu``
for NVIDIA Hopper (H100).

It mirrors the JAX package's module paths and is held against it by the
``tests/test_torch_*.py`` parity tests. Every TPU kernel on a ported path is
a hand-written Hopper kernel beside a plain PyTorch version of the same
function. Ported so far (slice 1, serving; slice 2, the O5 GPT training
step; slice 3, the O5 BERT + FusedLAMB pretraining step):

- ``beforeholiday_tpu_torch.ops``     — LayerNorm/RMSNorm forward and backward
  (kernels K1/K3, Triton), flash attention forward and backward (K2/K4, CUDA
  C++), dense/MLP blocks, flat arenas, the unscale, fused-Adam, LAMB and
  global-norm arena kernels (K5-K9, Triton).
- ``beforeholiday_tpu_torch.amp``     — opt levels O0/O5, device-side loss
  scaling, ``scaled_value_and_grad``.
- ``beforeholiday_tpu_torch.optimizers`` — ``FusedAdam``, ``FusedLAMB``,
  ``MasterWeights`` and ``FusedMixedPrecisionLamb``.
- ``beforeholiday_tpu_torch.infer``   — paged KV cache, bucketed inference
  engine, continuous batching.
- ``beforeholiday_tpu_torch.monitor`` — the strict bucket-signature gate.
- ``beforeholiday_tpu_torch.testing`` — the dense GPT and BERT, their losses
  and batches.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` or
hands them CPU tensors; with no card and no CPU request they raise.
"""

from beforeholiday_tpu_torch import (  # noqa: F401
    amp,
    infer,
    monitor,
    ops,
    optimizers,
    testing,
)

__version__ = "0.3.0"

__all__ = ["amp", "infer", "monitor", "ops", "optimizers", "testing"]
