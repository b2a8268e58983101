"""Shared helpers for the in-repo test models (GPT, BERT) — counterpart of
``beforeholiday_tpu/testing/_model_utils.py`` (the mesh-constraint helpers
have no single-device counterpart and are not ported), plus the numpy
loaders both models use to take the reference's own parameters and state."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from beforeholiday_tpu_torch.ops import fused_layer_norm
from beforeholiday_tpu_torch.ops._dispatch import resolve_device


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


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the block weights (stacked tensors, or tuples
    of per-layer tensors as ``PackedParams.grad_leaves`` hands them out)."""
    return {k: v[i] for k, v in params["blocks"].items()}


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
