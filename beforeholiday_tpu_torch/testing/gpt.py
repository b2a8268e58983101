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
the two packages draw different masks from one seed.

Mixture-of-Experts (``moe_every > 0``): every ``moe_every``-th block's MLP
is the routed expert layer of ``beforeholiday_tpu_torch.moe``, with one
routing group per call (the local batch). The layers run in groups of
``moe_every`` (``moe_every - 1`` dense blocks, then the MoE block), each
group under ``cfg.remat_policy``, as JAX scans them; the MoE layers' dense
MLP slots stay in the stacked tree (one tree shape for any ``moe_every``)
and get zero gradient. ``params["moe"]`` holds the router ``w_router (G, D,
E)`` and the stacked experts ``(G, E, ...)``; :func:`forward` with
``return_aux=True`` returns the router's scalars as means over the G MoE
layers, and :func:`loss_and_aux` adds the weighted router losses. With
``moe_expert_axis`` / ``moe_tensor_axis`` (inside an entered
``make_moe_mesh``) each rank holds its experts' shard and the layer
exchanges tokens over the expert group; the MoE path refuses the tensor
group of ``initialize_model_parallel``.

``remat_policy`` names a ``remat`` policy that wraps each block, as JAX
wraps its scanned block: ``"full"`` recomputes the block in the backward
from its input, the selective policies save what they name. The block's
output carries ``remat.TAG_BLOCK``. Dropout inside a block replays its
masks in the recompute, since the layer's keys are the block's inputs.

Tensor parallelism (Megatron's layout, the JAX model's :func:`param_specs`):
once ``parallel_state.initialize_model_parallel`` has run, the model runs on
this rank's shard (:func:`shard_params`) over the tensor group. QKV and
MLP-in are column-parallel (the input enters through the f region), the
attention projection and MLP-out row-parallel (the g region sums the
partial products), and the tied embedding vocab-parallel: the lookup is
``vocab_parallel_embedding`` and the head returns this rank's vocab shard of
the logits, which :func:`loss_fn` reduces with
``vocab_parallel_cross_entropy``. The block GEMMs stay ``fused_dense`` on
the local shards, one rounding each as in the dense model; a row-parallel
GEMM adds its bias on tensor rank 0 only (on the others a zero that carries
the bias's gradient, so every rank computes the bias's whole gradient), so
at a tensor world of one the forward is the dense forward, bit for bit.
With ``sequence_parallel`` the residual stream is laid out (S, B, D) and
split along S (Megatron's layout): the column-parallel inputs are gathered
(the backward reduce-scatters), the row-parallel outputs reduce-scattered,
and the LayerNorms are ``sp_fused_layer_norm``, whose parameter gradients
are all-reduced over the tensor group. Without model parallelism
``sequence_parallel`` changes nothing, as in JAX. :func:`embed`,
:func:`blocks` and :func:`head` are the forward's three parts, for the
pipeline schedules' ``embed_fn``, ``stage_fn`` and ``head_fn``.

Dropout under a tensor group draws the one-device model's masks, as JAX's
GSPMD model does: each rank draws only its part of them, through a rank
place (``ops.attention.RankPlace``). The attention probabilities of its
heads are the one-device planes ``b H + h0 + h`` (K2/K4, or K13 on the
unfused path); under sequence parallelism the residual's hidden sites are
its rows of the one-device ``(B, S, D)`` block; in the replicated region
every rank draws the whole mask, which is the same on all of them.

:func:`init` draws from the same distributions as the reference (different
numbers); :func:`params_from_numpy` and :func:`state_from_numpy` take the
reference's own parameters and optimizer/scaler state as numpy arrays, so
both packages can compute, and continue, the same training run.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.moe import (
    MoEConfig,
    expert_param_specs,
    init_experts,
    moe_layer,
)
from beforeholiday_tpu_torch.ops import (
    flash_attention,
    fused_dense,
    scaled_upper_triang_masked_softmax,
)
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.remat.policies import (
    TAG_BLOCK,
    apply as remat_apply,
    checkpoint_name,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel import mappings as mp
from beforeholiday_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel.layers import (
    vocab_parallel_embedding,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel.random import dropout
from beforeholiday_tpu_torch.testing._tensor_parallel import (  # noqa: F401
    TENSOR,
    _column_input,
    _heads,
    _heads_place,
    _hidden_dropout,
    _layernorm,
    _row_bias,
    _row_output,
    _seq_first,
    _tp_world,
    shard_tree,
    unshard_tree,
)
from beforeholiday_tpu_torch.testing._model_utils import (  # noqa: F401
    _tensor,
    layer_params,
    dropout_keys,
    params_from_numpy,
    state_from_numpy,
    vocab_head_matmul as _vocab_head_matmul,
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
    # every moe_every-th block's MLP is a routed expert layer (0: dense)
    moe_every: int = 0
    moe_experts: int = 4
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_z_weight: float = 1e-3
    # mesh-axis names moe_layer exchanges over (None: all experts local)
    moe_expert_axis: Optional[str] = None
    moe_tensor_axis: Optional[str] = None
    moe_hierarchical: bool = False

    def __post_init__(self):
        if self.moe_every and self.n_layers % self.moe_every:
            raise ValueError(f"n_layers ({self.n_layers}) must divide by "
                             f"moe_every ({self.moe_every})")
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

    @property
    def moe_groups(self) -> int:
        return self.n_layers // self.moe_every if self.moe_every else 0

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(n_experts=self.moe_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor,
                         aux_weight=self.moe_aux_weight,
                         z_weight=self.moe_z_weight)


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
    params = {
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
    if cfg.moe_every:
        G = cfg.moe_groups
        router = norm((G, D, cfg.moe_experts), init_std)
        groups = [init_experts(generator, cfg.moe_experts, D, Fd,
                               init_std=init_std, out_std=out_std, device=device)
                  for _ in range(G)]
        params["moe"] = {"w_router": router, "experts": {
            k: torch.stack([g[k] for g in groups]) for k in groups[0]}}
    return params


def param_specs(cfg: GPTConfig) -> dict:
    """Which dim of each leaf the tensor group shards (``"tensor"``), as
    the JAX model's ``PartitionSpec``s: column-parallel (QKV, MLP-in) shard
    the output dim, row-parallel (attention projection, MLP-out) the input
    dim, the embedding its vocab; the rest is replicated. The block leaves
    lead with the layer dim, which the pipe group splits."""
    t = TENSOR
    specs = {
        "tok_embed": (t, None),
        "pos_embed": (None, None),
        "blocks": {
            "ln1_scale": (None, None), "ln1_bias": (None, None),
            "wqkv": (None, None, t), "bqkv": (None, t),
            "wo": (None, t, None), "bo": (None, None),
            "ln2_scale": (None, None), "ln2_bias": (None, None),
            "wi": (None, None, t), "bi": (None, t),
            "wo2": (None, t, None), "bo2": (None, None),
        },
        "lnf_scale": (None,),
        "lnf_bias": (None,),
    }
    if cfg.moe_every:
        # the group dim leads; experts replicated (the expert-parallel
        # placement is the mesh's business), d_ff tensor-sharded as the MLP's
        specs["moe"] = {"w_router": (None, None, None), "experts": {
            k: (None, *s) for k, s in expert_param_specs(tensor_axis=t).items()}}
    return specs


def shard_params(params: dict, cfg: GPTConfig, tp_rank: int, tp_size: int,
                 pp_rank: int = 0, pp_size: int = 1) -> dict:
    """The shard of ``params`` (or of any tree of the same layout, such as
    gradients or masters) that tensor rank ``tp_rank`` of ``tp_size`` and
    pipe rank ``pp_rank`` of ``pp_size`` hold, cut along
    :func:`param_specs` (``testing/_tensor_parallel.py`` ``shard_tree``)."""
    return shard_tree(params, param_specs(cfg), cfg, tp_rank, tp_size, pp_rank,
                      pp_size)


def unshard_params(shards, cfg: GPTConfig) -> dict:
    """The whole tree from ``shards[pp_rank][tp_rank]`` (every rank's
    :func:`shard_params`), bit for bit."""
    return unshard_tree(shards, param_specs(cfg), cfg)


def _drop(cfg: GPTConfig, keys, t, site, rate):
    """Dropout with the key of a numbered site (``keys[site]``, JAX's
    ``fold_in(layer_key, site)``); no keys (eval) or rate 0 is the
    identity."""
    if keys is None or rate == 0.0:
        return t
    return _hidden_dropout(cfg, keys[site], t, rate)


def _attn_sublayer(cfg: GPTConfig, x, lp, keys=None):
    """ln1 + causal attention + residual. x: (B, S, D), or this rank's
    (S / tp, B, D) under sequence parallelism; ``keys``: the layer's site
    keys (None = eval)."""
    seq_first = _seq_first(cfg)
    h = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"], cfg)
    h = _column_input(h, cfg)
    qkv = fused_dense(h, lp["wqkv"].to(h.dtype), lp["bqkv"].to(h.dtype))
    n_heads = qkv.shape[-1] // (3 * cfg.head_dim)  # this rank's heads
    q, k, v = (_heads(t, n_heads, seq_first) for t in qkv.chunk(3, dim=-1))
    B, S = q.shape[0], q.shape[2]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    attn_rate = cfg.attention_dropout if keys is not None else 0.0
    attn_key = keys[0] if attn_rate > 0.0 else None
    if cfg.use_flash_attention:
        # no (B*H, S, S) score tensor in HBM; dropout inside K2/K4
        ctx = flash_attention(q, k, v, causal=True, scale=scale,
                              dropout_rate=attn_rate, dropout_key=attn_key,
                              impl=cfg.attention_impl,
                              dropout_place=_heads_place(n_heads, cfg))
    else:
        # the scores stay in the activation dtype, as JAX's product does
        scores = (q @ k.transpose(-1, -2)).reshape(B * n_heads, S, S)
        probs = scaled_upper_triang_masked_softmax(
            scores, scale, impl=cfg.attention_impl).to(x.dtype)
        probs = probs.reshape(B, n_heads, S, S)
        if attn_rate > 0.0:
            probs = dropout(attn_key, probs, attn_rate, impl=cfg.dropout_impl,
                            place=_heads_place(n_heads, cfg))
        # jnp's promotion: under O1/O4 the probabilities follow the fp32
        # residual stream while v is low precision, and the product is fp32
        dt = torch.promote_types(probs.dtype, v.dtype)
        ctx = probs.to(dt) @ v.to(dt)
    if seq_first:
        ctx = ctx.permute(2, 0, 1, 3).reshape(S, B, -1)
    else:
        ctx = ctx.transpose(1, 2).reshape(B, S, -1)
    attn_out = fused_dense(ctx, lp["wo"].to(x.dtype), _row_bias(lp["bo"]).to(x.dtype))
    attn_out = _row_output(attn_out, cfg)
    return x + _drop(cfg, keys, attn_out, 1, cfg.dropout_rate)


def _block(cfg: GPTConfig, x, lp, keys=None):
    """One dense transformer block. x: (B, S, D), or (S / tp, B, D) under
    sequence parallelism; ``keys``: the layer's site keys (None = eval)."""
    x = _attn_sublayer(cfg, x, lp, keys)
    h = _column_input(_layernorm(x, lp["ln2_scale"], lp["ln2_bias"], cfg), cfg)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(fused_dense(h, lp["wi"].to(h.dtype), lp["bi"].to(h.dtype)),
               approximate="tanh")
    mlp_out = fused_dense(h, lp["wo2"].to(x.dtype), _row_bias(lp["bo2"]).to(x.dtype))
    mlp_out = _row_output(mlp_out, cfg)
    x = x + _drop(cfg, keys, mlp_out, 2, cfg.dropout_rate)
    # remat boundary tag: the residual stream between blocks is the cheapest
    # possible save point — one (B, S, D) tensor per layer
    return checkpoint_name(x, TAG_BLOCK)


def _moe_block(cfg: GPTConfig, x, lp, w_router, experts, keys=None):
    """A block whose MLP is the routed expert layer: ``_block``'s attention
    half and dropout sites, the dense MLP slots of ``lp`` unused. Returns
    ``(x, aux)`` with the layer's router scalars."""
    x = _attn_sublayer(cfg, x, lp, keys)
    h = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"], cfg)
    B, S, D = h.shape
    # one routing group per rank: every local token competes for the same
    # expert capacity (GShard's group = the local batch)
    y, aux = moe_layer(h.reshape(B * S, D), w_router, experts, cfg.moe_cfg(),
                       expert_axis=cfg.moe_expert_axis,
                       tensor_axis=cfg.moe_tensor_axis,
                       hierarchical=cfg.moe_hierarchical)
    x = x + _drop(cfg, keys, y.reshape(B, S, D), 2, cfg.dropout_rate)
    return checkpoint_name(x, TAG_BLOCK), aux


def _moe_group(cfg: GPTConfig, x, lps, w_router, experts, keys):
    """One group of ``moe_every`` layers: dense blocks, then the MoE
    block."""
    for lp, k in zip(lps[:-1], keys[:-1]):
        x = _block(cfg, x, lp, k)
    return _moe_block(cfg, x, lps[-1], w_router, experts, keys[-1])


_MOE_AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction")


def _zero_moe_aux(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in _MOE_AUX_KEYS}


def _forward_moe_stack(params: dict, x, cfg: GPTConfig, keys):
    """The layer stack in groups of ``moe_every``, each group under
    ``cfg.remat_policy``; returns ``(x, aux)`` with aux the means over the
    ``moe_groups`` MoE layers."""
    if _tp_world():
        raise NotImplementedError(
            "the MoE blocks do not run on the tensor group of "
            "initialize_model_parallel; shard the experts' d_ff with "
            "moe_tensor_axis inside a make_moe_mesh instead")
    G, every = cfg.moe_groups, cfg.moe_every
    # one tensor a group: one ``unbind``, whose backward writes each stacked
    # leaf's gradient once
    routers = params["moe"]["w_router"].unbind(0)
    experts = {k: v.unbind(0) for k, v in params["moe"]["experts"].items()}
    grp = remat_apply(functools.partial(_moe_group, cfg), cfg.remat_policy)
    aux = _zero_moe_aux(x.device)
    for g in range(G):
        layers = range(g * every, (g + 1) * every)
        x, aux_g = grp(x, [layer_params(params, i) for i in layers],
                       routers[g], {k: v[g] for k, v in experts.items()},
                       [keys[i] for i in layers])
        aux = {k: aux[k] + aux_g[k] for k in _MOE_AUX_KEYS}
    return x, {k: aux[k] / G for k in _MOE_AUX_KEYS}


def embed(params: dict, tokens: torch.Tensor, cfg: GPTConfig,
          emb_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) → the residual stream in ``cfg.dtype``: the token and
    position embeddings (vocab-parallel under a tensor group; split along S
    as (S / tp, B, D) under sequence parallelism), with the embedding
    site's dropout when ``emb_key`` is given."""
    S = tokens.shape[1]
    if _tp_world():
        tok = vocab_parallel_embedding(tokens, params["tok_embed"],
                                       vocab_size=cfg.vocab_size, axis_name=TENSOR)
    else:
        tok = params["tok_embed"][tokens]
    x = (tok + params["pos_embed"][:S]).to(cfg.dtype)
    if _seq_first(cfg):
        x = mp.scatter_to_sequence_parallel_region(x.transpose(0, 1), TENSOR)
    if emb_key is not None and cfg.dropout_rate > 0.0:
        x = _hidden_dropout(cfg, emb_key, x, cfg.dropout_rate)
    return x


def blocks(params: dict, x: torch.Tensor, cfg: GPTConfig, keys=None) -> torch.Tensor:
    """The transformer blocks of ``params["blocks"]`` (stacked leaves or
    tuples of per-layer leaves; a pipeline stage's layers) on the residual
    stream, each under ``cfg.remat_policy``; ``keys``: per-layer site keys
    (None = eval). The dense blocks only: an MoE model runs its stack
    through :func:`forward`."""
    if cfg.moe_every:
        raise NotImplementedError("blocks() runs the dense stack; an MoE "
                                  "model's stack runs inside forward()")
    n = len(next(iter(params["blocks"].values())))
    keys = [None] * n if keys is None else keys
    blk = remat_apply(functools.partial(_block, cfg), cfg.remat_policy)
    for i in range(n):
        x = blk(x, layer_params(params, i), keys[i])
    return x


def head(params: dict, x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """The final LayerNorm and the tied vocab head: (B, S, V) fp32 logits,
    or this tensor rank's (B, S, V / tp) shard of them."""
    h = _layernorm(x, params["lnf_scale"], params["lnf_bias"], cfg)
    if _seq_first(cfg):
        # the head is column-parallel over the vocab: gather the sequence
        h = mp.gather_from_sequence_parallel_region(h, TENSOR, True)
        # (B, S, D) in the dense layout: the head's GEMM then reads what the
        # dense model's reads, so at a tensor world of one it is its bits
        h = h.transpose(0, 1).contiguous()
    elif _tp_world():
        h = mp.copy_to_tensor_model_parallel_region(h, TENSOR)
    return _vocab_head_matmul(h, params["tok_embed"])


def forward(params: dict, tokens: torch.Tensor, cfg: GPTConfig,
            dropout_key: Optional[torch.Tensor] = None,
            return_aux: bool = False):
    """tokens (B, S) integer → logits (B, S, V) fp32 (this tensor rank's
    vocab shard under a tensor group). ``dropout_key`` switches the cfg
    dropout sites on (None = eval: identity). ``return_aux=True`` also
    returns the MoE aux dict (the router's scalars, means over the MoE
    layers; all zeros for the dense model)."""
    emb_key, keys = dropout_keys(dropout_key, cfg.n_layers)
    x = embed(params, tokens, cfg, emb_key)
    if cfg.moe_every:
        x, aux = _forward_moe_stack(params, x, cfg, keys)
    else:
        x, aux = blocks(params, x, cfg, keys), None
    logits = head(params, x, cfg)
    if return_aux:
        return logits, (_zero_moe_aux(logits.device) if aux is None else aux)
    return logits


def _cross_entropy(logits, targets):
    """Mean next-token cross entropy: the dense logsumexp form, or under a
    tensor group ``vocab_parallel_cross_entropy`` on the vocab shards."""
    if _tp_world():
        return vocab_parallel_cross_entropy(logits, targets, logits.shape[-1]
                                            * _tp_world(), axis_name=TENSOR).mean()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (logz - tgt).mean()


def loss_and_aux(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                 cfg: GPTConfig, dropout_key: Optional[torch.Tensor] = None):
    """``(loss, aux)``: the next-token cross entropy (with dropout when a
    key is given) plus, with ``moe_every``, the router losses weighted by
    ``moe_aux_weight`` and ``moe_z_weight``; and the MoE aux dict, all zeros
    for the dense model."""
    logits, aux = forward(params, tokens, cfg, dropout_key, return_aux=True)
    loss = _cross_entropy(logits, targets)
    if cfg.moe_every:
        loss = (loss + cfg.moe_aux_weight * aux["moe_aux_loss"]
                + cfg.moe_z_weight * aux["moe_z_loss"])
    return loss, aux


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: GPTConfig, forward_fn=None) -> torch.Tensor:
    """Mean next-token cross entropy. ``forward_fn(params, tokens)``
    overrides the plain forward (e.g. an amp-wrapped apply) while keeping
    one loss definition. With ``moe_every`` (and no ``forward_fn``) the
    weighted router losses ride along, as :func:`loss_and_aux` adds them."""
    if forward_fn is None:
        if cfg.moe_every:
            return loss_and_aux(params, tokens, targets, cfg)[0]
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
