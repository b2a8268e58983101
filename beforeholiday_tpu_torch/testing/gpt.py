"""Standalone GPT language model — the dense path of
``beforeholiday_tpu/testing/gpt.py``, for serving and for training.

A pure function over a parameter dict with the reference's layout: the block
weights are stacked along a leading layer axis, and :func:`forward` loops
over layers in Python where the JAX model scans. :func:`layer_params` also
takes the block weights as a tuple of per-layer tensors, which is how
``PackedParams.grad_leaves`` hands them out so that each layer's gradient
lands in its own slice of the gradient arena. The forward is differentiable
(K1/K3 and K2/K4 carry their own backward). The MoE, dropout, sequence
parallel and remat fields of :class:`GPTConfig` are accepted for parity but
must stay at their defaults: those paths belong to later slices.

:func:`init` draws from the same distributions as the reference (different
numbers); :func:`params_from_numpy` and :func:`state_from_numpy` take the
reference's own parameters and optimizer/scaler state as numpy arrays, so
both packages can compute, and continue, the same training run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.ops import flash_attention, fused_dense
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.testing._model_utils import (
    layernorm as _layernorm,
    vocab_head_matmul as _vocab_head_matmul,
)

# fields whose non-default values select paths this slice does not port
_UNPORTED_FIELDS = (
    "sequence_parallel", "use_flash_attention", "dropout_rate",
    "attention_dropout", "remat_policy", "moe_every", "moe_experts",
    "moe_top_k", "moe_capacity_factor", "moe_aux_weight", "moe_z_weight",
    "moe_expert_axis", "moe_tensor_axis", "moe_hierarchical",
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 512
    seq_len: int = 128
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: Optional[int] = None  # default 4*d_model
    dtype: torch.dtype = torch.float32  # activation/compute dtype
    sequence_parallel: bool = False
    use_flash_attention: bool = True
    attention_impl: Optional[str] = None  # None | "kernel" | "torch"
    # port only: the LayerNorm's impl (K1/K3 or their plain version)
    norm_impl: Optional[str] = None
    dropout_rate: float = 0.0
    attention_dropout: float = 0.0
    remat_policy: Optional[str] = None
    moe_every: int = 0
    moe_experts: int = 4
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_z_weight: float = 1e-3
    moe_expert_axis: Optional[str] = None
    moe_tensor_axis: Optional[str] = None
    moe_hierarchical: bool = False

    def __post_init__(self):
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name in _UNPORTED_FIELDS:
            if getattr(self, name) != defaults[name]:
                raise NotImplementedError(
                    f"GPTConfig.{name}={getattr(self, name)!r} selects a path "
                    f"that is not ported yet (default {defaults[name]!r})"
                )
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads {self.n_heads}"
            )

    @property
    def ff(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init(cfg: GPTConfig, generator: torch.Generator, device=None) -> dict:
    """fp32 parameters with the reference's shapes and standard deviations.
    Draws on ``generator``'s device, then moves to ``device``."""
    device = resolve_device(device)
    D, Fd, L, V, S = cfg.d_model, cfg.ff, cfg.n_layers, cfg.vocab_size, cfg.seq_len

    def norm(shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * std).to(device)

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    init_std = 0.02
    out_std = init_std / math.sqrt(2.0 * L)  # depth-scaled, as Megatron does
    return {
        "tok_embed": norm((V, D), init_std),
        "pos_embed": norm((S, D), init_std),
        "blocks": {
            "ln1_scale": const((L, D), 1.0),
            "ln1_bias": const((L, D), 0.0),
            "wqkv": norm((L, D, 3 * D), init_std),
            "bqkv": const((L, 3 * D), 0.0),
            "wo": norm((L, D, D), out_std),
            "bo": const((L, D), 0.0),
            "ln2_scale": const((L, D), 1.0),
            "ln2_bias": const((L, D), 0.0),
            "wi": norm((L, D, Fd), init_std),
            "bi": const((L, Fd), 0.0),
            "wo2": norm((L, Fd, D), out_std),
            "bo2": const((L, D), 0.0),
        },
        "lnf_scale": const((D,), 1.0),
        "lnf_bias": const((D,), 0.0),
    }


def params_from_numpy(tree, device=None):
    """The reference's parameter tree, as numpy arrays (``jax.tree.map(
    np.asarray, params)``), turned into this package's tensors on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 ones as the reference stores them, through
    ml_dtypes) as a tensor of the same dtype on ``device``."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def state_from_numpy(tree, device=None):
    """The reference's optimizer or scaler state as numpy (``jax.tree.map(
    np.asarray, state)``: nested dicts, tuples and lists of arrays and
    0-d counters) turned into this package's tensors on ``device``, the
    structure kept. A JAX ``MasterWeights`` state over ``PackedParams``
    (``{"inner": ({"exp_avg", "exp_avg_sq", "step"}, ...), "master": (...)}``)
    becomes the port's, so a JAX run can be continued here."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    return _tensor(tree, device)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the block weights (stacked tensors, or tuples
    of per-layer tensors)."""
    return {k: v[i] for k, v in params["blocks"].items()}


def _heads(t, n_heads):
    B, S, D = t.shape
    return t.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)


def _attn_sublayer(cfg: GPTConfig, x, lp):
    """ln1 + causal attention + residual. x: (B, S, D)."""
    B, S, D = x.shape
    h = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"], impl=cfg.norm_impl)
    qkv = fused_dense(h, lp["wqkv"].to(h.dtype), lp["bqkv"].to(h.dtype))
    q, k, v = (_heads(t, cfg.n_heads) for t in qkv.chunk(3, dim=-1))
    ctx = flash_attention(q, k, v, causal=True, scale=1.0 / math.sqrt(cfg.head_dim),
                          impl=cfg.attention_impl)
    ctx = ctx.transpose(1, 2).reshape(B, S, D)
    return x + fused_dense(ctx, lp["wo"].to(x.dtype), lp["bo"].to(x.dtype))


def _block(cfg: GPTConfig, x, lp):
    """One dense transformer block. x: (B, S, D)."""
    x = _attn_sublayer(cfg, x, lp)
    h = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"], impl=cfg.norm_impl)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(fused_dense(h, lp["wi"].to(h.dtype), lp["bi"].to(h.dtype)),
               approximate="tanh")
    return x + fused_dense(h, lp["wo2"].to(x.dtype), lp["bo2"].to(x.dtype))


def forward(params: dict, tokens: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """tokens (B, S) integer → logits (B, S, V) fp32 (no dropout)."""
    S = tokens.shape[1]
    x = params["tok_embed"][tokens] + params["pos_embed"][:S]
    x = x.to(cfg.dtype)
    for i in range(cfg.n_layers):
        x = _block(cfg, x, layer_params(params, i))
    x = _layernorm(x, params["lnf_scale"], params["lnf_bias"],
                   impl=cfg.norm_impl)
    return _vocab_head_matmul(x, params["tok_embed"])


def _cross_entropy(logits, targets):
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (logz - tgt).mean()


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: GPTConfig, forward_fn=None) -> torch.Tensor:
    """Mean next-token cross entropy. ``forward_fn(params, tokens)``
    overrides the plain forward (e.g. an amp-wrapped apply) while keeping
    one loss definition."""
    if forward_fn is None:
        logits = forward(params, tokens, cfg)
    else:
        logits = forward_fn(params, tokens)
    return _cross_entropy(logits, targets)


def synthetic_batch(cfg: GPTConfig, batch: int, *, generator: torch.Generator,
                    device=None):
    """``(tokens, targets)``: uniform random tokens drawn on ``generator``'s
    device, moved to ``device``; targets are the tokens shifted by one."""
    device = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len),
                           generator=generator, device=generator.device)
    tokens = tokens.to(device)
    return tokens, torch.roll(tokens, -1, dims=-1)
