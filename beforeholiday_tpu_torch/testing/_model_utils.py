"""Shared helpers for the in-repo test models (GPT, BERT) — counterpart of
``beforeholiday_tpu/testing/_model_utils.py`` (the mesh-constraint helpers
have no single-device counterpart and are not ported), plus the numpy
loaders the models (GPT, BERT, ``models/resnet.py``) use to take the
reference's own parameters and state."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from beforeholiday_tpu_torch.ops import fused_layer_norm
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.ops.arena import is_namedtuple
from beforeholiday_tpu_torch.parallel.sync_batch_norm import (
    BatchNormParams,
    BatchNormState,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel.random import (
    fold_in,
    split,
)

# this package's namedtuples, by class name: ``jax.tree.map`` keeps the
# reference's classes, which this package cannot import
_NAMEDTUPLES = {c.__name__: c for c in (BatchNormParams, BatchNormState)}


def layernorm(x, scale, bias, impl: Optional[str] = None):
    """Fused LN; fp32 gamma/beta may meet bf16 activations uncast — the
    kernel computes in fp32 internally."""
    return fused_layer_norm(x, scale, bias, impl=impl)


def vocab_head_matmul(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits ``x @ embedding.T`` returned UNROUNDED in fp32.

    JAX multiplies in x's compute dtype with an fp32 accumulator. Widening
    both low-precision operands to fp32 first is exact, so the fp32 product
    here gives the same sums without the bf16 rounding of the output that a
    bf16 ``torch.matmul`` would add (which flips greedy argmax ties)."""
    w = embedding.to(x.dtype).float()
    return torch.matmul(x.float(), w.t())


def dropout_keys(dropout_key: Optional[torch.Tensor], n_layers: int,
                 n_sites: int = 3):
    """The model's dropout keys as JAX's models derive them one by one:
    ``(embedding key, site keys)`` with the embedding's ``fold_in(key,
    0x7FFFFFFF)`` and an ``(n_layers, n_sites, 2)`` tensor of ``fold_in(
    split(key, n_layers)[i], site)`` for sites 0 (the attention
    probabilities), 1 and 2. Two batched hash evaluations, so a step
    launches a few hundred small integer ops on the device rather than
    thousands. No key (eval) gives ``(None, [None] * n_layers)``."""
    if dropout_key is None:
        return None, [None] * n_layers
    parents = torch.cat((dropout_key[None], split(dropout_key, n_layers)))
    data = torch.arange(n_sites, dtype=torch.int64, device=dropout_key.device)
    data = data.expand(n_layers + 1, n_sites).clone()
    data[0] = 0x7FFFFFFF
    keys = fold_in(parents[:, None], data)
    return keys[0, 0], keys[1:]


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the block weights (stacked tensors, or tuples
    of per-layer tensors as ``PackedParams.grad_leaves`` hands them out)."""
    return {k: v[i] for k, v in params["blocks"].items()}


def _port_namedtuple(tree):
    """This package's namedtuple class for one of the reference's: the same
    class name and fields."""
    cls = _NAMEDTUPLES.get(type(tree).__name__)
    if cls is None or cls._fields != type(tree)._fields:
        raise ValueError(f"no counterpart here for the namedtuple "
                         f"{type(tree).__name__}{type(tree)._fields}")
    return cls


def params_from_numpy(tree, device=None):
    """The reference's parameter tree, as numpy arrays (``jax.tree.map(
    np.asarray, params)``: dicts and namedtuples of arrays), turned into this
    package's tensors on ``device``; a namedtuple becomes this package's
    class of the same name and fields."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if is_namedtuple(tree):
        return _port_namedtuple(tree)(*(params_from_numpy(v, device) for v in tree))
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
    0-d counters; or a model state such as ResNet's BN running stats, whose
    namedtuples become this package's classes) turned into this package's
    tensors on ``device``, the structure kept. A JAX ``MasterWeights`` state
    over ``PackedParams`` (``{"inner": ({"exp_avg", "exp_avg_sq", "step"},
    ...), "master": (...)}``) becomes the port's, so a JAX run can be
    continued here."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if is_namedtuple(tree):
        return _port_namedtuple(tree)(*(state_from_numpy(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    return _tensor(tree, device)
