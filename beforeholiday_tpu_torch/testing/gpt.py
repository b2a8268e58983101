"""Standalone GPT language model — the dense path of
``beforeholiday_tpu/testing/gpt.py``, for serving and for training.

A pure function over a parameter dict with the reference's layout: the block
weights are stacked along a leading layer axis, and :func:`forward` loops
over layers in Python where the JAX model scans. :func:`layer_params` also
takes the block weights as a tuple of per-layer tensors, which is how
``PackedParams.grad_leaves`` hands them out so that each layer's gradient
lands in its own slice of the gradient arena. The forward is differentiable
(K1/K3, K2/K4 and K11/K12 carry their own backward). Attention runs through
flash attention (K2/K4) or, with ``use_flash_attention=False``, the unfused
path: materialized bf16 scores, the causal scaled softmax (K11/K12), then
``probs @ v``.

Dropout follows the JAX model: the rates act only when :func:`forward` gets
a ``dropout_key``. The embedding site draws from ``fold_in(key,
0x7FFFFFFF)``, layer i from ``split(key, n_layers)[i]``, and within a layer
the attention probabilities from ``fold_in(layer_key, 0)`` (inside K2/K4,
or through :func:`~beforeholiday_tpu_torch.transformer.tensor_parallel.random.dropout`
on the unfused path's bf16 probabilities), the attention output from site
1 and the MLP output from site 2. The hidden sites and the unfused
probabilities draw their masks from K13. The keys are the port's own, so
the two packages draw different masks from one seed. The MoE, sequence
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

import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.ops import (
    flash_attention,
    fused_dense,
    scaled_upper_triang_masked_softmax,
)
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.transformer.tensor_parallel.random import dropout
from beforeholiday_tpu_torch.testing._model_utils import (  # noqa: F401
    _tensor,
    layer_params,
    dropout_keys,
    layernorm as _layernorm,
    params_from_numpy,
    state_from_numpy,
    vocab_head_matmul as _vocab_head_matmul,
)

# fields whose non-default values select paths this slice does not port
_UNPORTED_FIELDS = (
    "sequence_parallel", "remat_policy", "moe_every", "moe_experts",
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
    # None | "kernel" | "torch": flash attention's impl (K2/K4 or their plain
    # version), or with use_flash_attention=False the softmax's (K11/K12 or
    # theirs)
    attention_impl: Optional[str] = None
    # port only: the LayerNorm's impl (K1/K3 or their plain version)
    norm_impl: Optional[str] = None
    # port only: the dropout masks' impl outside flash attention (K13 or its
    # plain version)
    dropout_impl: Optional[str] = None
    # active only when forward() gets a dropout_key
    dropout_rate: float = 0.0          # embedding + post-attn + post-MLP
    attention_dropout: float = 0.0     # softmax-probs dropout
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


def _heads(t, n_heads):
    B, S, D = t.shape
    return t.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)


def _drop(cfg: GPTConfig, keys, t, site, rate):
    """Dropout with the key of a numbered site (``keys[site]``, JAX's
    ``fold_in(layer_key, site)``); no keys (eval) or rate 0 is the
    identity."""
    if keys is None or rate == 0.0:
        return t
    return dropout(keys[site], t, rate, impl=cfg.dropout_impl)


def _attn_sublayer(cfg: GPTConfig, x, lp, keys=None):
    """ln1 + causal attention + residual. x: (B, S, D); ``keys``: the
    layer's site keys (None = eval)."""
    B, S, D = x.shape
    h = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"], impl=cfg.norm_impl)
    qkv = fused_dense(h, lp["wqkv"].to(h.dtype), lp["bqkv"].to(h.dtype))
    q, k, v = (_heads(t, cfg.n_heads) for t in qkv.chunk(3, dim=-1))
    scale = 1.0 / math.sqrt(cfg.head_dim)
    attn_rate = cfg.attention_dropout if keys is not None else 0.0
    attn_key = keys[0] if attn_rate > 0.0 else None
    if cfg.use_flash_attention:
        # no (B*H, S, S) score tensor in HBM; dropout inside K2/K4
        ctx = flash_attention(q, k, v, causal=True, scale=scale,
                              dropout_rate=attn_rate, dropout_key=attn_key,
                              impl=cfg.attention_impl)
    else:
        # the scores stay in the activation dtype, as JAX's product does
        scores = (q @ k.transpose(-1, -2)).reshape(B * cfg.n_heads, S, S)
        probs = scaled_upper_triang_masked_softmax(
            scores, scale, impl=cfg.attention_impl).to(x.dtype)
        probs = probs.reshape(B, cfg.n_heads, S, S)
        if attn_rate > 0.0:
            probs = dropout(attn_key, probs, attn_rate, impl=cfg.dropout_impl)
        # jnp's promotion: under O1/O4 the probabilities follow the fp32
        # residual stream while v is low precision, and the product is fp32
        dt = torch.promote_types(probs.dtype, v.dtype)
        ctx = probs.to(dt) @ v.to(dt)
    ctx = ctx.transpose(1, 2).reshape(B, S, D)
    attn_out = fused_dense(ctx, lp["wo"].to(x.dtype), lp["bo"].to(x.dtype))
    return x + _drop(cfg, keys, attn_out, 1, cfg.dropout_rate)


def _block(cfg: GPTConfig, x, lp, keys=None):
    """One dense transformer block. x: (B, S, D); ``keys``: the layer's
    site keys (None = eval)."""
    x = _attn_sublayer(cfg, x, lp, keys)
    h = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"], impl=cfg.norm_impl)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(fused_dense(h, lp["wi"].to(h.dtype), lp["bi"].to(h.dtype)),
               approximate="tanh")
    mlp_out = fused_dense(h, lp["wo2"].to(x.dtype), lp["bo2"].to(x.dtype))
    return x + _drop(cfg, keys, mlp_out, 2, cfg.dropout_rate)


_MOE_AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction")


def forward(params: dict, tokens: torch.Tensor, cfg: GPTConfig,
            dropout_key: Optional[torch.Tensor] = None,
            return_aux: bool = False):
    """tokens (B, S) integer → logits (B, S, V) fp32. ``dropout_key``
    switches the cfg dropout sites on (None = eval: identity).
    ``return_aux=True`` also returns the MoE aux dict, all zeros for the
    dense model."""
    S = tokens.shape[1]
    x = params["tok_embed"][tokens] + params["pos_embed"][:S]
    x = x.to(cfg.dtype)
    emb_key, keys = dropout_keys(dropout_key, cfg.n_layers)
    if emb_key is not None and cfg.dropout_rate > 0.0:
        x = dropout(emb_key, x, cfg.dropout_rate, impl=cfg.dropout_impl)
    for i in range(cfg.n_layers):
        x = _block(cfg, x, layer_params(params, i), keys[i])
    x = _layernorm(x, params["lnf_scale"], params["lnf_bias"],
                   impl=cfg.norm_impl)
    logits = _vocab_head_matmul(x, params["tok_embed"])
    if return_aux:
        return logits, {k: torch.zeros((), dtype=torch.float32,
                                       device=logits.device)
                        for k in _MOE_AUX_KEYS}
    return logits


def _cross_entropy(logits, targets):
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (logz - tgt).mean()


def loss_and_aux(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                 cfg: GPTConfig, dropout_key: Optional[torch.Tensor] = None):
    """``(loss, aux)``: the next-token cross entropy (with dropout when a
    key is given) and the MoE aux dict, all zeros for the dense model."""
    logits, aux = forward(params, tokens, cfg, dropout_key, return_aux=True)
    return _cross_entropy(logits, targets), aux


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
