"""Mixed-precision policy engine — counterpart of ``beforeholiday_tpu/amp``.

Opt levels O0 and O5 (O1-O4 and O6 raise ``NotImplementedError``), dynamic
or static loss scaling carried in device state, and fp32 master weights over
flat arenas.
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
from beforeholiday_tpu_torch.ops._autocast import (  # noqa: F401
    float_function,
    half_function,
)
from beforeholiday_tpu_torch.optimizers.fused import MasterWeights  # noqa: F401
