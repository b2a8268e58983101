"""Kernel-backed ops — counterpart of ``beforeholiday_tpu/ops``.

* ``normalization`` — LayerNorm / RMSNorm forward on kernel K1 (Triton).
* ``attention`` — flash-attention forward on kernel K2 (CUDA C++).
* ``dense`` — dense and MLP blocks on library GEMMs.
* ``arena`` — the flat-buffer carving the paged KV cache uses.

On a CUDA tensor a kernel-backed op launches its kernel or raises; on a CPU
tensor it runs the kernel's plain PyTorch version.
"""

from .arena import ArenaSpec, make_spec, unflatten  # noqa: F401
from .attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
    is_flash_available,
)
from .dense import fused_dense, fused_dense_gelu_dense, mlp  # noqa: F401
from .normalization import (  # noqa: F401
    fused_layer_norm,
    fused_rms_norm,
    mixed_dtype_fused_layer_norm,
    mixed_dtype_fused_rms_norm,
)

__all__ = [
    "ArenaSpec",
    "flash_attention",
    "flash_attention_with_lse",
    "fused_dense",
    "fused_dense_gelu_dense",
    "fused_layer_norm",
    "fused_rms_norm",
    "is_flash_available",
    "make_spec",
    "mixed_dtype_fused_layer_norm",
    "mixed_dtype_fused_rms_norm",
    "mlp",
    "unflatten",
]
