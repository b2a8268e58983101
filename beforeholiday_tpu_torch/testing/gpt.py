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
the two packages draw different masks from one seed. The MoE and remat
fields of :class:`GPTConfig` are accepted for parity but must stay at their
defaults: those paths belong to later slices.

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
pipeline schedules' ``embed_fn``, ``stage_fn`` and ``head_fn``. Dropout
under a tensor group of more than one rank is not ported (ROADMAP A15).

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
from beforeholiday_tpu_torch.parallel import parallel_state
from beforeholiday_tpu_torch.transformer.layers.layer_norm import sp_fused_layer_norm
from beforeholiday_tpu_torch.transformer.tensor_parallel import mappings as mp
from beforeholiday_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel.layers import (
    vocab_parallel_embedding,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel.random import dropout
from beforeholiday_tpu_torch.testing._model_utils import (  # noqa: F401
    _tensor,
    layer_params,
    dropout_keys,
    params_from_numpy,
    state_from_numpy,
    vocab_head_matmul as _vocab_head_matmul,
)

# fields whose non-default values select paths this slice does not port
_UNPORTED_FIELDS = (
    "remat_policy", "moe_every", "moe_experts",
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


TENSOR = parallel_state.TENSOR_AXIS


def param_specs(cfg: GPTConfig) -> dict:
    """Which dim of each leaf the tensor group shards (``"tensor"``), as
    the JAX model's ``PartitionSpec``s: column-parallel (QKV, MLP-in) shard
    the output dim, row-parallel (attention projection, MLP-out) the input
    dim, the embedding its vocab; the rest is replicated. The block leaves
    lead with the layer dim, which the pipe group splits."""
    t = TENSOR
    return {
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


def _qkv_heads(t: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """``wqkv``'s (..., 3D) or ``bqkv``'s (..., 3D) columns as (..., 3, H,
    head_dim): [q | k | v], each over every head."""
    return t.reshape(*t.shape[:-1], 3, cfg.n_heads, cfg.head_dim)


def shard_params(params: dict, cfg: GPTConfig, tp_rank: int, tp_size: int,
                 pp_rank: int = 0, pp_size: int = 1) -> dict:
    """The shard of ``params`` (or of any tree of the same layout, such as
    gradients or masters) that tensor rank ``tp_rank`` of ``tp_size`` and
    pipe rank ``pp_rank`` of ``pp_size`` hold: the pipe rank's layers of
    each block leaf, cut along :func:`param_specs`'s tensor dim; the other
    leaves whole on every pipe rank. ``wqkv``/``bqkv`` are cut by heads: a
    rank holds its heads' q, k and v columns ([q | k | v] over its heads),
    where a contiguous cut of the last dim would hand rank 0 all of q.
    Copies, so the shard owns its storage."""
    if cfg.n_heads % tp_size or cfg.vocab_size % tp_size or cfg.ff % tp_size:
        raise ValueError(f"heads {cfg.n_heads}, vocab {cfg.vocab_size} and d_ff "
                         f"{cfg.ff} must divide by the tensor size {tp_size}")
    if cfg.n_layers % pp_size:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by the pipe "
                         f"size {pp_size}")
    per = cfg.n_layers // pp_size
    lo = pp_rank * per
    hl = cfg.n_heads // tp_size
    specs = param_specs(cfg)

    def cut(name, leaf, spec):
        if name in ("wqkv", "bqkv"):
            heads = _qkv_heads(leaf, cfg)[..., tp_rank * hl:(tp_rank + 1) * hl, :]
            return heads.reshape(*leaf.shape[:-1], 3 * hl * cfg.head_dim)
        if TENSOR in spec:
            dim = spec.index(TENSOR)
            n = leaf.shape[dim] // tp_size
            return leaf.narrow(dim, tp_rank * n, n)
        return leaf

    out = {k: cut(k, v, specs[k]).clone() for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: cut(k, v[lo:lo + per], specs["blocks"][k]).clone()
                     for k, v in params["blocks"].items()}
    return out


def unshard_params(shards, cfg: GPTConfig) -> dict:
    """The whole tree from ``shards[pp_rank][tp_rank]`` (every rank's
    :func:`shard_params`): the inverse of :func:`shard_params`, bit for
    bit. Replicated leaves come from tensor rank 0 and, outside the blocks,
    pipe rank 0."""
    pp_size, tp_size = len(shards), len(shards[0])
    hl = cfg.n_heads // tp_size
    specs = param_specs(cfg)

    def join(name, pieces, spec):
        if name in ("wqkv", "bqkv"):
            heads = [p.reshape(*p.shape[:-1], 3, hl, cfg.head_dim) for p in pieces]
            whole = torch.cat(heads, dim=-2)
            return whole.reshape(*whole.shape[:-3], 3 * cfg.d_model)
        if TENSOR in spec:
            return torch.cat(pieces, dim=spec.index(TENSOR))
        return pieces[0]

    row = shards[0]
    out = {k: join(k, [s[k] for s in row], specs[k])
           for k in row[0] if k != "blocks"}
    out["blocks"] = {
        k: torch.cat([join(k, [s["blocks"][k] for s in stage], specs["blocks"][k])
                      for stage in shards])
        for k in row[0]["blocks"]}
    return out


def _tp_world() -> int:
    """The tensor group's size once model parallelism is initialized, else
    0 (the dense model)."""
    if not parallel_state.model_parallel_is_initialized():
        return 0
    return parallel_state.get_tensor_model_parallel_world_size()


def _seq_first(cfg: GPTConfig) -> bool:
    """Whether the residual stream is laid out (S, B, D) and split along S
    over the tensor group."""
    return cfg.sequence_parallel and _tp_world() > 0


def _column_input(h, cfg: GPTConfig):
    """A column-parallel GEMM's input: gathered along S under sequence
    parallelism (the backward reduce-scatters), else through the f region
    (the backward all-reduces)."""
    if not _tp_world():
        return h
    if cfg.sequence_parallel:
        return mp.gather_from_sequence_parallel_region(h, TENSOR, True)
    return mp.copy_to_tensor_model_parallel_region(h, TENSOR)


def _row_output(y, cfg: GPTConfig):
    """A row-parallel GEMM's partial products summed over the tensor group
    (reduce-scattered along S under sequence parallelism)."""
    if not _tp_world():
        return y
    if cfg.sequence_parallel:
        return mp.reduce_scatter_to_sequence_parallel_region(y, TENSOR)
    return mp.reduce_from_tensor_model_parallel_region(y, TENSOR)


def _row_bias(b):
    """A row-parallel GEMM's bias: whole on tensor rank 0; on the others a
    zero that carries the bias's gradient, so the sum adds it once and every
    rank's gradient of it is whole."""
    if _tp_world() and parallel_state.get_tensor_model_parallel_rank() != 0:
        return b - b.detach()
    return b


def _layernorm(x, scale, bias, cfg: GPTConfig):
    """Fused LN (K1/K3); fp32 gamma/beta may meet bf16 activations uncast.
    Under sequence parallelism the parameter gradients are all-reduced over
    the tensor group."""
    return sp_fused_layer_norm(x, scale, bias, sequence_parallel=_seq_first(cfg),
                               impl=cfg.norm_impl)


def _heads(t, n_heads, seq_first=False):
    """(B, S, D) — or (S, B, D) with ``seq_first`` — as (B, H, S, D / H)."""
    if seq_first:
        S, B, D = t.shape
        return t.reshape(S, B, n_heads, D // n_heads).permute(1, 2, 0, 3)
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
                              impl=cfg.attention_impl)
    else:
        # the scores stay in the activation dtype, as JAX's product does
        scores = (q @ k.transpose(-1, -2)).reshape(B * n_heads, S, S)
        probs = scaled_upper_triang_masked_softmax(
            scores, scale, impl=cfg.attention_impl).to(x.dtype)
        probs = probs.reshape(B, n_heads, S, S)
        if attn_rate > 0.0:
            probs = dropout(attn_key, probs, attn_rate, impl=cfg.dropout_impl)
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
    return x + _drop(cfg, keys, mlp_out, 2, cfg.dropout_rate)


_MOE_AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction")


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
    if emb_key is not None and cfg.dropout_rate > 0.0:
        x = dropout(emb_key, x, cfg.dropout_rate, impl=cfg.dropout_impl)
    if _seq_first(cfg):
        x = mp.scatter_to_sequence_parallel_region(x.transpose(0, 1), TENSOR)
    return x


def blocks(params: dict, x: torch.Tensor, cfg: GPTConfig, keys=None) -> torch.Tensor:
    """The transformer blocks of ``params["blocks"]`` (stacked leaves or
    tuples of per-layer leaves; a pipeline stage's layers) on the residual
    stream; ``keys``: per-layer site keys (None = eval)."""
    n = len(next(iter(params["blocks"].values())))
    keys = [None] * n if keys is None else keys
    for i in range(n):
        x = _block(cfg, x, layer_params(params, i), keys[i])
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
    returns the MoE aux dict, all zeros for the dense model."""
    if dropout_key is not None and _tp_world() > 1:
        raise NotImplementedError(
            "dropout under a tensor group of more than one rank is not ported "
            "yet: ROADMAP A15")
    emb_key, keys = dropout_keys(dropout_key, cfg.n_layers)
    x = embed(params, tokens, cfg, emb_key)
    logits = head(params, blocks(params, x, cfg, keys), cfg)
    if return_aux:
        return logits, {k: torch.zeros((), dtype=torch.float32,
                                       device=logits.device)
                        for k in _MOE_AUX_KEYS}
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
