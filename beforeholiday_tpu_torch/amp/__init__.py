"""Mixed-precision policy engine — counterpart of ``beforeholiday_tpu/amp``.

Opt levels O0-O6 (O6: the fp8 GEMM tier, ``ops.quantized``, with its amax
history in the loss scaler), dynamic or static loss scaling carried in
device state, fp32 master weights over flat arenas, and the per-op cast
policy of O1/O4 (the autocast scope and the tags).
"""

from beforeholiday_tpu_torch.amp.frontend import (  # noqa: F401
    AmpModel,
    Properties,
    initialize,
    make_apply,
    opt_levels,
    scaled_value_and_grad,
)
from beforeholiday_tpu_torch.amp.scaler import LossScaler  # noqa: F401
from beforeholiday_tpu_torch.amp import functional  # noqa: F401
# the per-op cast policy lives in ops, below the op layer in the import
# graph, and is re-exported here as the reference's amp API
from beforeholiday_tpu_torch.ops._autocast import (  # noqa: F401
    autocast,
    autocast_dtype,
    banned_function,
    bfloat16_function,
    float_function,
    half_function,
    promote_function,
)
from beforeholiday_tpu_torch.optimizers.fused import MasterWeights  # noqa: F401
