"""Activation memory: named remat policies — counterpart of
``beforeholiday_tpu/remat``.

``remat.apply(fn, "save_boundaries")`` wraps a model block or a pipeline
stage with a named rematerialization policy (see ``policies``). The memory
ledger that measures the effect lives in
``beforeholiday_tpu_torch.monitor.memory``. The JAX package's
``remat/donation.py`` has no counterpart: the port's optimizers update the
arenas in place, which is what donation buys XLA.
"""

from beforeholiday_tpu_torch.remat import policies
from beforeholiday_tpu_torch.remat.policies import (
    BOUNDARY_TAGS,
    TAG_ATTN_OUT,
    TAG_BLOCK,
    TAG_FLASH_LSE,
    TAG_MOE_COMBINE,
    TAG_MOE_DISPATCH,
    TAG_NORM_OUT,
    ZERO3_GATHERED_TAG,
    Policy,
    apply,
    available_policies,
    checkpoint_name,
    register_policy,
    resolve,
)

__all__ = [
    "BOUNDARY_TAGS",
    "Policy",
    "TAG_ATTN_OUT",
    "TAG_BLOCK",
    "TAG_FLASH_LSE",
    "TAG_MOE_COMBINE",
    "TAG_MOE_DISPATCH",
    "TAG_NORM_OUT",
    "ZERO3_GATHERED_TAG",
    "apply",
    "available_policies",
    "checkpoint_name",
    "policies",
    "register_policy",
    "resolve",
]
