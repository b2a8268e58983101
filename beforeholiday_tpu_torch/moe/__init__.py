"""Mixture-of-Experts — counterpart of ``beforeholiday_tpu/moe``.

Top-k routing with static capacity (``moe.router``), the grouped expert FFN
as one batched GEMM a projection over a stacked, arena-friendly tree
(``moe.experts``), and expert-parallel dispatch and combine over the
ledgered, differentiable ``all_to_all`` on the ``expert`` group of a
``make_moe_mesh`` carve, also over the ``("slice", "intra")`` pair
(``moe.dispatch``).
"""

from beforeholiday_tpu_torch.moe.dispatch import (
    dense_oracle,
    expert_all_to_all,
    moe_layer,
)
from beforeholiday_tpu_torch.moe.experts import (
    expert_ffn,
    expert_param_specs,
    init_experts,
)
from beforeholiday_tpu_torch.moe.router import (
    MoEConfig,
    RouterDecision,
    dense_gates,
    route,
    router_logits,
)

__all__ = [
    "MoEConfig",
    "RouterDecision",
    "dense_gates",
    "dense_oracle",
    "expert_all_to_all",
    "expert_ffn",
    "expert_param_specs",
    "init_experts",
    "moe_layer",
    "route",
    "router_logits",
]
