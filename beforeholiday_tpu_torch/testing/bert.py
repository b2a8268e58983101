"""Standalone BERT (MLM + NSP pretraining) — counterpart of
``beforeholiday_tpu/testing/bert.py``, the model behind the BERT-Large +
FusedLAMB pretraining step.

A pure function over a parameter dict with the reference's layout: the
encoder weights are stacked along a leading layer axis, :func:`forward`
loops over layers in Python where the JAX model scans, and
:func:`~beforeholiday_tpu_torch.testing._model_utils.layer_params` also takes
the per-layer tuples that ``PackedParams.grad_leaves`` hands out. Post-LN
blocks (``LN(x + sublayer(x))``, cast back to the activation dtype),
bidirectional attention with key padding, the MLM head (dense, tanh-GELU,
LayerNorm, then the tied decoder) and the NSP head off the pooled [CLS].
Attention runs through flash attention's ``kv_lens`` (kernels K2/K4,
non-causal) or, with ``use_flash_attention=False``, the unfused path:
materialized scores, ``scaled_masked_softmax`` with the (B, 1, 1, S)
key-padding mask built on the device from the lengths (K11/K12), then
``probs @ v``.

The dtypes follow the JAX model under amp O5: the three embedding lookups
are added in bf16 in JAX's order, the MLM transform is a plain bf16
``x @ w + b``, the tied decoder returns unrounded fp32 logits to which the
bf16 output bias is added in fp32, and NSP multiplies in fp32.

Dropout follows the JAX model: with a ``dropout_key`` the embedding site
draws from ``fold_in(key, 0x7FFFFFFF)``, layer i from ``split(key,
n_layers)[i]``, and within a layer the attention probabilities from
``fold_in(layer_key, 0)`` (inside K2/K4, or on the unfused path's bf16
probabilities through K13's mask), the attention output from site 1 and
the MLP output from site 2. ``remat_policy`` wraps each encoder block as
the GPT's does (``testing/gpt.py``). :func:`init` draws
from the reference's distributions (different numbers);
``params_from_numpy`` takes the reference's own parameters.

Tensor parallelism (Megatron's layout, the JAX model's :func:`param_specs`,
which JAX runs under GSPMD): once ``parallel_state.initialize_model_parallel``
has run, the model runs on this rank's shard (:func:`shard_params`) over
the tensor group, as the GPT does: QKV and MLP-in column-parallel, the
attention projection and MLP-out row-parallel (the bias on tensor rank 0),
the word embedding vocab-parallel, and the tied MLM decoder over this rank's
vocab shard (with its shard of ``mlm_out_bias``), whose logits
:func:`pretrain_loss` reduces with ``vocab_parallel_cross_entropy``. The
embeddings, their LayerNorm, the MLM transform and the NSP head are
replicated; the MLM transform's output enters the decoder through the f
region, so every rank holds the replicated leaves' whole gradients. With
``sequence_parallel`` the residual stream is laid out (S, B, D) and split
along S: the post-LN LayerNorms are ``sp_fused_layer_norm`` (their
parameter gradients all-reduced over the tensor group), the last hidden is
gathered for the heads, and the hidden dropout sites draw the rank's rows
of the one-device masks (the attention probabilities its heads' planes).
At a tensor world of one the forward is the dense forward, bit for bit.
:func:`tensor_sharded` marks the sharded leaves for ``FusedLAMB``, whose
trust ratios and clip norm need their squares summed over the group.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.ops import (
    flash_attention,
    fused_dense,
    scaled_masked_softmax,
)
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.parallel import parallel_state
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
from beforeholiday_tpu_torch.testing._model_utils import (  # noqa: F401
    layer_params,
    dropout_keys,
    layernorm as _dense_layernorm,
    params_from_numpy,
    vocab_head_matmul as _vocab_head_matmul,
)
from beforeholiday_tpu_torch.testing._tensor_parallel import (
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

@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 512
    seq_len: int = 128
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: Optional[int] = None  # default 4*d_model
    type_vocab_size: int = 2
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
    dropout_rate: float = 0.0
    attention_dropout: float = 0.0
    remat_policy: Optional[str] = None

    def __post_init__(self):
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


def bert_large(**kw) -> BertConfig:
    """The BERT-Large architecture (24 x 1024 x 16, vocab 30522)."""
    base = dict(vocab_size=30522, seq_len=512, d_model=1024, n_heads=16,
                n_layers=24)
    base.update(kw)
    return BertConfig(**base)


def init(cfg: BertConfig, generator: torch.Generator, device=None) -> dict:
    """fp32 parameters with the reference's shapes and standard deviations
    (``wo`` and ``wo2`` scaled by ``1/sqrt(2L)``). Draws on ``generator``'s
    device, then moves to ``device``."""
    device = resolve_device(device)
    D, Fd, L, V = cfg.d_model, cfg.ff, cfg.n_layers, cfg.vocab_size
    std = 0.02
    depth = 1.0 / math.sqrt(2.0 * L)

    def norm(shape, scale=1.0):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * std * scale).to(device)

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "tok_embed": norm((V, D)),
        "pos_embed": norm((cfg.seq_len, D)),
        "type_embed": norm((cfg.type_vocab_size, D)),
        "embed_ln_scale": const((D,), 1.0),
        "embed_ln_bias": const((D,), 0.0),
        "blocks": {
            "wqkv": norm((L, D, 3 * D)),
            "bqkv": const((L, 3 * D), 0.0),
            "wo": norm((L, D, D), depth),
            "bo": const((L, D), 0.0),
            "ln1_scale": const((L, D), 1.0),
            "ln1_bias": const((L, D), 0.0),
            "wi": norm((L, D, Fd)),
            "bi": const((L, Fd), 0.0),
            "wo2": norm((L, Fd, D), depth),
            "bo2": const((L, D), 0.0),
            "ln2_scale": const((L, D), 1.0),
            "ln2_bias": const((L, D), 0.0),
        },
        "mlm_dense": norm((D, D)),
        "mlm_bias": const((D,), 0.0),
        "mlm_ln_scale": const((D,), 1.0),
        "mlm_ln_bias": const((D,), 0.0),
        "mlm_out_bias": const((V,), 0.0),
        "pool_w": norm((D, D)),
        "pool_b": const((D,), 0.0),
        "nsp_w": norm((D, 2)),
        "nsp_b": const((2,), 0.0),
    }


def param_specs(cfg: BertConfig) -> dict:
    """Which dim of each leaf the tensor group shards (``"tensor"``), as
    the JAX model's ``PartitionSpec``s (Megatron's layout): QKV and MLP-in
    column-parallel, the attention projection and MLP-out row-parallel, the
    word embedding and the MLM output bias by vocab; the rest replicated.
    The block leaves lead with the layer dim."""
    t = TENSOR
    return {
        "tok_embed": (t, None), "pos_embed": (None, None),
        "type_embed": (None, None), "embed_ln_scale": (None,),
        "embed_ln_bias": (None,),
        "blocks": {
            "wqkv": (None, None, t), "bqkv": (None, t),
            "wo": (None, t, None), "bo": (None, None),
            "ln1_scale": (None, None), "ln1_bias": (None, None),
            "wi": (None, None, t), "bi": (None, t),
            "wo2": (None, t, None), "bo2": (None, None),
            "ln2_scale": (None, None), "ln2_bias": (None, None),
        },
        "mlm_dense": (None, None), "mlm_bias": (None,),
        "mlm_ln_scale": (None,), "mlm_ln_bias": (None,), "mlm_out_bias": (t,),
        "pool_w": (None, None), "pool_b": (None,),
        "nsp_w": (None, None), "nsp_b": (None,),
    }


def tensor_sharded(cfg: BertConfig) -> dict:
    """A tree of bools, True at the leaves the tensor group shards (for
    ``FusedLAMB(tensor_sharded=...)``)."""
    def mark(spec):
        return {k: mark(v) for k, v in spec.items()} if isinstance(spec, dict) \
            else TENSOR in spec
    return mark(param_specs(cfg))


def shard_params(params: dict, cfg: BertConfig, tp_rank: int, tp_size: int) -> dict:
    """This tensor rank's shard of ``params`` (or of any tree of the same
    layout): ``wqkv``/``bqkv`` by heads, the other sharded leaves along
    :func:`param_specs`'s tensor dim."""
    return shard_tree(params, param_specs(cfg), cfg, tp_rank, tp_size)


def unshard_params(shards, cfg: BertConfig) -> dict:
    """The whole tree from every tensor rank's :func:`shard_params`, in rank
    order, bit for bit."""
    return unshard_tree([list(shards)], param_specs(cfg), cfg)


def _attention(cfg: BertConfig, q, k, v, lens, attn_key=None, place=None):
    """Bidirectional attention with key-padding lengths; q, k, v (B, H, S,
    hd) → (B, H, S, hd). ``attn_key``: the probabilities' dropout key (None
    = eval); ``place``: this tensor rank's heads, whose masks it draws."""
    S = q.shape[2]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    rate = cfg.attention_dropout if attn_key is not None else 0.0
    if cfg.use_flash_attention:
        return flash_attention(q, k, v, causal=False, scale=scale,
                               kv_lens=lens, dropout_rate=rate,
                               dropout_key=attn_key, impl=cfg.attention_impl,
                               dropout_place=place)
    scores = q @ k.transpose(-1, -2)
    mask = (torch.arange(S, device=lens.device)[None, :] >= lens[:, None])
    probs = scaled_masked_softmax(scores, mask[:, None, None, :], scale,
                                  impl=cfg.attention_impl).to(q.dtype)
    if rate > 0.0:
        probs = dropout(attn_key, probs, rate, impl=cfg.dropout_impl, place=place)
    return probs @ v


def _block(cfg: BertConfig, x, lens, lp, keys=None):
    """One post-LN encoder block. x: (B, S, D), or this rank's (S / tp, B,
    D) under sequence parallelism; lens: (B,) key lengths; ``keys``: the
    layer's site keys, JAX's ``fold_in(layer_key, site)`` (None = eval)."""
    seq_first = _seq_first(cfg)

    def drop(t, site):
        if keys is None or cfg.dropout_rate == 0.0:
            return t
        return _hidden_dropout(cfg, keys[site], t, cfg.dropout_rate)

    h = _column_input(x, cfg)
    qkv = fused_dense(h, lp["wqkv"].to(x.dtype), lp["bqkv"].to(x.dtype))
    n_heads = qkv.shape[-1] // (3 * cfg.head_dim)  # this rank's heads
    q, k, v = (_heads(t, n_heads, seq_first) for t in qkv.chunk(3, dim=-1))
    B, S = q.shape[0], q.shape[2]
    attn_key = (keys[0]
                if keys is not None and cfg.attention_dropout > 0.0 else None)
    ctx = _attention(cfg, q, k, v, lens, attn_key, _heads_place(n_heads, cfg))
    ctx = (ctx.permute(2, 0, 1, 3).reshape(S, B, -1) if seq_first
           else ctx.transpose(1, 2).reshape(B, S, -1))
    attn_out = _row_output(fused_dense(ctx, lp["wo"].to(x.dtype),
                                       _row_bias(lp["bo"]).to(x.dtype)), cfg)
    x = _layernorm(x + drop(attn_out, 1), lp["ln1_scale"], lp["ln1_bias"],
                   cfg).to(x.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(fused_dense(_column_input(x, cfg), lp["wi"].to(x.dtype),
                           lp["bi"].to(x.dtype)), approximate="tanh")
    mlp_out = _row_output(fused_dense(h, lp["wo2"].to(x.dtype),
                                      _row_bias(lp["bo2"]).to(x.dtype)), cfg)
    x = _layernorm(x + drop(mlp_out, 2), lp["ln2_scale"], lp["ln2_bias"],
                   cfg).to(x.dtype)
    # remat boundary tag: one (B, S, D) residual per layer (see testing/gpt.py)
    return checkpoint_name(x, TAG_BLOCK)


def forward(params: dict, tokens: torch.Tensor, cfg: BertConfig,
            token_types: Optional[torch.Tensor] = None,
            seq_lens: Optional[torch.Tensor] = None,
            dropout_key: Optional[torch.Tensor] = None):
    """tokens (B, S) integer → ``(mlm_logits (B, S, V) fp32, nsp_logits
    (B, 2) fp32)``; under a tensor group the MLM logits are this rank's
    vocab shard ``(B, S, V / tp)``. ``seq_lens`` (B,) masks keys at index
    >= length; ``dropout_key`` switches the cfg dropout sites on (None =
    eval)."""
    B, S = tokens.shape
    lens = (seq_lens if seq_lens is not None else
            torch.full((B,), S, dtype=torch.int32, device=tokens.device))
    if _tp_world():
        tok = vocab_parallel_embedding(tokens, params["tok_embed"],
                                       vocab_size=cfg.vocab_size, axis_name=TENSOR)
    else:
        tok = params["tok_embed"][tokens]
    x = tok + params["pos_embed"][:S]
    if token_types is not None:
        x = x + params["type_embed"][token_types]
    else:
        x = x + params["type_embed"][0]
    x = _dense_layernorm(x, params["embed_ln_scale"], params["embed_ln_bias"],
                         impl=cfg.norm_impl)
    x = x.to(cfg.dtype)
    if _seq_first(cfg):
        x = mp.scatter_to_sequence_parallel_region(x.transpose(0, 1), TENSOR)
    emb_key, keys = dropout_keys(dropout_key, cfg.n_layers)
    if emb_key is not None and cfg.dropout_rate > 0.0:
        x = _hidden_dropout(cfg, emb_key, x, cfg.dropout_rate)
    # cfg.remat_policy wraps each encoder block (lens an explicit input, as
    # in JAX)
    blk = remat_apply(functools.partial(_block, cfg), cfg.remat_policy)
    for i in range(cfg.n_layers):
        x = blk(x, lens, layer_params(params, i), keys[i])
    if _seq_first(cfg):
        # the heads read the whole sequence; the MLM transform's output
        # enters the vocab-parallel decoder through the f region below, so
        # the gradient arriving here is whole on every rank: split it
        x = mp.gather_from_sequence_parallel_region(x, TENSOR, False).transpose(0, 1)

    # MLM head: dense + GELU + LN in the activation dtype, then the tied
    # decoder's unrounded fp32 logits plus the output bias
    h = F.gelu(torch.matmul(x, params["mlm_dense"].to(x.dtype))
               + params["mlm_bias"].to(x.dtype), approximate="tanh")
    h = _dense_layernorm(h, params["mlm_ln_scale"], params["mlm_ln_bias"],
                         impl=cfg.norm_impl)
    if _tp_world():
        h = mp.copy_to_tensor_model_parallel_region(h, TENSOR)
    mlm = _vocab_head_matmul(h, params["tok_embed"]) + params["mlm_out_bias"].float()

    # NSP head off the pooled [CLS] (position 0); JAX promotes the fp32
    # pooled vector @ a bf16 weight to fp32, torch needs it said
    pooled = torch.tanh(torch.matmul(x[:, 0], params["pool_w"].to(x.dtype))
                        + params["pool_b"].to(x.dtype))
    nsp = pooled.float() @ params["nsp_w"].float() + params["nsp_b"].float()
    return mlm, nsp


def pretrain_loss(params, tokens, mlm_targets, mlm_mask, nsp_labels,
                  cfg: BertConfig, seq_lens=None,
                  dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MLM cross entropy over the masked positions only (divided by
    ``max(sum(mask), 1)``) plus the mean NSP cross entropy. The port's
    ``dropout_key`` (not in JAX's signature) trains with dropout."""
    mlm, nsp = forward(params, tokens, cfg, seq_lens=seq_lens,
                       dropout_key=dropout_key)
    if _tp_world():
        per_token = vocab_parallel_cross_entropy(mlm, mlm_targets.long(),
                                                 cfg.vocab_size, axis_name=TENSOR)
    else:
        logz = torch.logsumexp(mlm, dim=-1)
        per_token = logz - mlm.gather(-1, mlm_targets[..., None].long())[..., 0]
    mask = mlm_mask.float()
    mlm_loss = (per_token * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    nsp_logz = torch.logsumexp(nsp, dim=-1)
    nsp_tgt = nsp.gather(-1, nsp_labels[:, None].long())[:, 0]
    return mlm_loss + (nsp_logz - nsp_tgt).mean()


def mask_token_id(cfg: BertConfig) -> int:
    """[MASK] = the last vocab slot (the synthetic stand-in for id 103)."""
    return cfg.vocab_size - 1


def synthetic_batch(cfg: BertConfig, batch: int, *, generator: torch.Generator,
                    device=None, mask_frac: float = 0.15):
    """Random MLM batch ``(tokens, targets, mlm_mask, nsp_labels)``, drawn on
    ``generator``'s device and moved to ``device``. Masked positions hold
    [MASK] in the input; the targets keep the original tokens."""
    device = resolve_device(device)
    gdev = generator.device
    targets = torch.randint(0, cfg.vocab_size - 1, (batch, cfg.seq_len),
                            generator=generator, device=gdev)
    mlm_mask = (torch.rand((batch, cfg.seq_len), generator=generator,
                           device=gdev) < mask_frac).float()
    tokens = torch.where(mlm_mask > 0, mask_token_id(cfg), targets)
    nsp = torch.randint(0, 2, (batch,), generator=generator, device=gdev)
    return tuple(t.to(device) for t in (tokens, targets, mlm_mask, nsp))
