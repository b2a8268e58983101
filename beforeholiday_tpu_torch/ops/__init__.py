"""Kernel-backed ops — counterpart of ``beforeholiday_tpu/ops``.

* ``normalization`` — LayerNorm / RMSNorm on kernels K1/K3 (Triton).
* ``attention`` — flash attention on kernels K2/K4 (CUDA C++).
* ``dense`` — dense and MLP blocks on library GEMMs.
* ``arena`` — flat arenas and ``PackedParams``.
* ``multi_tensor`` — unscale and fused Adam over arenas, K5/K6 (Triton).

On a CUDA tensor a kernel-backed op launches its kernel or raises; on a CPU
tensor it runs the kernel's plain PyTorch version.
"""

from .arena import (  # noqa: F401
    ArenaSpec,
    PackedLayout,
    PackedParams,
    bucket_by_dtype,
    flatten,
    make_spec,
    unflatten,
    views_to_arena,
)
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

from .multi_tensor import (  # noqa: F401
    adam_flat,
    multi_tensor_adam,
    multi_tensor_scale,
)

__all__ = [
    "ArenaSpec",
    "PackedLayout",
    "PackedParams",
    "adam_flat",
    "bucket_by_dtype",
    "flatten",
    "multi_tensor_adam",
    "multi_tensor_scale",
    "views_to_arena",
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
