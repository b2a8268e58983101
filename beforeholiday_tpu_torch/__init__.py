"""beforeholiday_tpu_torch — the PyTorch/CUDA port of ``beforeholiday_tpu``
for NVIDIA Hopper (H100).

It mirrors the JAX package's module paths and is held against it by the
``tests/test_torch_*.py`` parity tests. Every TPU kernel on a ported path is
a hand-written Hopper kernel beside a plain PyTorch version of the same
function. Ported so far (slice 1, serving):

- ``beforeholiday_tpu_torch.ops``     — LayerNorm/RMSNorm forward (kernel K1,
  Triton), flash-attention forward (kernel K2, CUDA C++), dense/MLP blocks.
- ``beforeholiday_tpu_torch.infer``   — paged KV cache, bucketed inference
  engine, continuous batching.
- ``beforeholiday_tpu_torch.monitor`` — the strict bucket-signature gate.
- ``beforeholiday_tpu_torch.testing`` — the dense eval-mode GPT.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` or
hands them CPU tensors; with no card and no CPU request they raise.
"""

from beforeholiday_tpu_torch import infer, monitor, ops, testing  # noqa: F401

__version__ = "0.1.0"

__all__ = ["infer", "monitor", "ops", "testing"]
