"""Kernel-backed ops — counterpart of ``beforeholiday_tpu/ops``.

* ``normalization`` — LayerNorm / RMSNorm on kernels K1/K3 (Triton).
* ``attention`` — flash attention on kernels K2/K4 (CUDA C++).
* ``dense`` — dense and MLP blocks on library GEMMs.
* ``arena`` — flat arenas and ``PackedParams``.
* ``multi_tensor`` — unscale, fused Adam, global L2 norm, fused LAMB and
  fused SGD over arenas, K5-K10 (Triton).
* ``softmax`` — the scaled / masked / causal softmax family on kernels
  K11/K12 (Triton).

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

from .softmax import (  # noqa: F401
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from .multi_tensor import (  # noqa: F401
    adam_flat,
    lamb_flat,
    multi_tensor_adam,
    multi_tensor_l2norm,
    multi_tensor_lamb,
    multi_tensor_scale,
)

__all__ = [
    "ArenaSpec",
    "PackedLayout",
    "PackedParams",
    "adam_flat",
    "bucket_by_dtype",
    "flatten",
    "lamb_flat",
    "multi_tensor_adam",
    "multi_tensor_l2norm",
    "multi_tensor_lamb",
    "multi_tensor_scale",
    "views_to_arena",
    "flash_attention",
    "flash_attention_with_lse",
    "fused_dense",
    "fused_dense_gelu_dense",
    "fused_layer_norm",
    "fused_rms_norm",
    "generic_scaled_masked_softmax",
    "is_flash_available",
    "make_spec",
    "mixed_dtype_fused_layer_norm",
    "mixed_dtype_fused_rms_norm",
    "mlp",
    "scaled_masked_softmax",
    "scaled_softmax",
    "scaled_upper_triang_masked_softmax",
    "unflatten",
]
