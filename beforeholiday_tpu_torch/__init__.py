"""beforeholiday_tpu_torch — the PyTorch/CUDA port of ``beforeholiday_tpu``
for NVIDIA Hopper (H100).

It mirrors the JAX package's module paths and is held against it by the
``tests/test_torch_*.py`` parity tests. Every TPU kernel on a ported path is
a hand-written Hopper kernel beside a plain PyTorch version of the same
function. Ported so far (slice 1, serving; slice 2, the O5 GPT training
step; slice 3, the O5 BERT + FusedLAMB pretraining step; slice 4, the
ImageNet ResNet-50 training step at O5 and O0 with FusedSGD; slice 5, the
unfused-attention GPT and BERT steps):

- ``beforeholiday_tpu_torch.ops``     — LayerNorm/RMSNorm forward and backward
  (kernels K1/K3, Triton), flash attention forward and backward (K2/K4, CUDA
  C++), dense/MLP blocks, flat arenas, the unscale, fused-Adam, LAMB,
  global-norm and fused-SGD arena kernels (K5-K10, Triton), the scaled /
  masked / causal softmax family (K11/K12, Triton).
- ``beforeholiday_tpu_torch.amp``     — opt levels O0/O5, device-side loss
  scaling, ``scaled_value_and_grad``.
- ``beforeholiday_tpu_torch.optimizers`` — ``FusedAdam``, ``FusedLAMB``,
  ``FusedSGD``, ``MasterWeights`` and ``FusedMixedPrecisionLamb``.
- ``beforeholiday_tpu_torch.models``  — the ResNet family.
- ``beforeholiday_tpu_torch.parallel`` — single-device BatchNorm.
- ``beforeholiday_tpu_torch.examples.imagenet`` — the ImageNet ResNet
  trainer (``main_amp``).
- ``beforeholiday_tpu_torch.infer``   — paged KV cache, bucketed inference
  engine, continuous batching.
- ``beforeholiday_tpu_torch.monitor`` — the strict bucket-signature gate.
- ``beforeholiday_tpu_torch.testing`` — the dense GPT and BERT (flash or
  unfused attention), their losses and batches.
- ``beforeholiday_tpu_torch.transformer`` — the enums and
  ``functional.FusedScaleMaskSoftmax``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` or
hands them CPU tensors; with no card and no CPU request they raise.
"""

from beforeholiday_tpu_torch import (  # noqa: F401
    amp,
    infer,
    models,
    monitor,
    ops,
    optimizers,
    parallel,
    testing,
    transformer,
)

__version__ = "0.5.0"

__all__ = ["amp", "infer", "models", "monitor", "ops", "optimizers",
           "parallel", "testing", "transformer"]
