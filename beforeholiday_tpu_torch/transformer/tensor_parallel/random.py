"""Dropout keys, dropout and activation checkpointing — counterpart of
``beforeholiday_tpu/transformer/tensor_parallel/random.py``.

JAX's PRNG key is a value that ``fold_in`` and ``split`` derive new keys
from, so the reference's RNG-state tracker collapses into plain arithmetic
on keys. The port keeps that discipline: a key is an int64 tensor of shape
``(2,)`` holding two 32-bit words on the model's device, and :func:`fold_in`
and :func:`split` derive keys with the same Philox4x32-10 hash that draws
the dropout masks (``ops/attention.py`` :func:`philox4x32`), in integer
torch ops on that device. A step can therefore key its dropout on the
optimizer's device step count without reading anything back to the host.
The keys are not JAX's: the two packages draw different masks from a seed.

:func:`dropout` draws its keep mask from K13 (``csrc/dropout_mask.cu``) on
the card, or its plain version on the CPU, and applies it in one
``torch.where``. The mask of ``x`` of shape ``(..., rows, cols)`` is that of
the coordinate block ``(prod(...), rows, cols)``, so attention
probabilities ``(B, H, Sq, Sk)`` dropped here get the very mask that flash
attention draws in-kernel at ``(b H + h, query, key)`` under the same key.

Because the key is a value, :func:`checkpoint` needs no RNG state: a
recomputed region draws the same masks again. :func:`model_parallel_seed`
and :func:`data_parallel_seed` fold the rank along a ``parallel_state``
axis into the key, as JAX folds ``axis_index``: the rank is a host int, so
the fold runs on the device with no host sync. A tensor-parallel model that
must draw its one-device masks instead passes :func:`dropout` a ``place``
(``ops.attention.RankPlace``): the rank's part of the one-device block.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from beforeholiday_tpu_torch.ops._dispatch import resolve_device, resolve_impl
from beforeholiday_tpu_torch.ops.attention import (
    RankPlace,
    _check_key,
    dropout_keep_mask,
    philox4x32,
)
from beforeholiday_tpu_torch.remat.policies import apply as remat_apply

TENSOR_AXIS = "tensor"
DATA_AXIS = "data"
_MASK32 = 0xFFFFFFFF
# the hash counter's last two words for key derivation; masks count with
# (col, row, bh, 0), so a key's derived keys never reuse a mask's words
_FOLD_TAG, _SPLIT_TAG = 0x464F4C44, 0x53504C54
# the reference's offset: tensor-parallel seed = seed + 2718 + tp_rank
# (apex/transformer/tensor_parallel/random.py:204-234)
_MODEL_PARALLEL_OFFSET = 2718


def make_key(seed: Optional[int] = None, *,
             generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
    """A dropout key on ``device`` (the card unless asked otherwise): from
    an int ``seed`` (its low 64 bits), or two words drawn from
    ``generator``."""
    device = resolve_device(device)
    if (seed is None) == (generator is None):
        raise ValueError("make_key takes a seed or a generator, not both")
    if generator is not None:
        key = torch.randint(0, 1 << 32, (2,), generator=generator,
                            device=generator.device, dtype=torch.int64)
        return key.to(device)
    seed = int(seed)
    return torch.tensor([seed & _MASK32, (seed >> 32) & _MASK32],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """The key derived from ``key`` and ``data``: an int, or an integer
    tensor (a device step count is read on the device). ``key`` may also be
    a batch of keys ``(..., 2)`` and ``data`` a tensor broadcasting against
    the batch, which derives them all in one hash evaluation: the result is
    ``(*batch, 2)``."""
    if not (isinstance(key, torch.Tensor) and key.dtype == torch.int64
            and key.shape[-1:] == (2,)):
        raise ValueError("fold_in takes a key, or a batch of keys: an int64 "
                         f"tensor of shape (..., 2); got {key!r}")
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device, dtype=torch.int64)
    else:
        data = int(data)
    w = philox4x32(data & _MASK32, (data >> 32) & _MASK32, _FOLD_TAG, 1,
                   key[..., 0], key[..., 1])
    return torch.stack(torch.broadcast_tensors(w[0], w[1]), -1)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` keys derived from ``key``, as an ``(n, 2)`` tensor."""
    _check_key(key)
    i = torch.arange(int(n), dtype=torch.int64, device=key.device)
    w = philox4x32(i, 0, _SPLIT_TAG, 1, key[0], key[1])
    return torch.stack((w[0], w[1]), -1)


def _axis_index(axis_name) -> int:
    """This process's rank along ``axis_name`` (a ``parallel_state`` axis
    or a process group), JAX's ``axis_index``; raises outside a
    ``torch.distributed`` world, or on an axis model parallelism has not
    bound."""
    import torch.distributed as dist

    from beforeholiday_tpu_torch.parallel.parallel_state import get_group

    return dist.get_rank(get_group(axis_name))


def model_parallel_seed(key: torch.Tensor, axis_name: str = TENSOR_AXIS):
    """Per tensor-parallel rank key (distinct dropout masks per shard):
    ``fold_in(key, 2718 + rank)``, the rank along ``axis_name``."""
    return fold_in(key, _MODEL_PARALLEL_OFFSET + _axis_index(axis_name))


def data_parallel_seed(key: torch.Tensor, axis_name: str = DATA_AXIS):
    """Per data-parallel rank key (independent augmentation per replica):
    ``fold_in(key, rank)``, the rank along ``axis_name``."""
    return fold_in(key, _axis_index(axis_name))


def dropout(
    key: Optional[torch.Tensor],
    x: torch.Tensor,
    rate: float,
    *,
    tp_distinct: bool = False,
    axis_name: str = TENSOR_AXIS,
    deterministic: bool = False,
    impl: Optional[str] = None,
    place: Optional[RankPlace] = None,
) -> torch.Tensor:
    """Inverted dropout: survivors scaled by ``1 / (1 - rate)``, where the
    rate's complement is first rounded to x's dtype as JAX rounds a Python
    scalar to a bf16 operand. Identity at rate 0 or when ``deterministic``.
    ``tp_distinct`` draws from :func:`model_parallel_seed` (a distinct mask
    on every rank along ``axis_name``). ``impl`` picks the mask's kernel
    (K13) or its plain version; ``place`` makes x's mask the rank's part of
    the one-device tensor's (x's ``(prod(lead), rows, cols)`` block at that
    place)."""
    if deterministic or rate == 0.0:
        return x
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if key is None:
        raise ValueError("dropout at rate > 0 needs a key")
    _check_key(key, x.device)
    if tp_distinct:
        key = model_parallel_seed(key, axis_name)
    shape = (1, 1, 1, *x.shape)[-3:] if x.ndim < 3 else (
        math.prod(x.shape[:-2]), *x.shape[-2:])
    keep = dropout_keep_mask(key, shape, rate,
                             impl=resolve_impl(impl, x, op="dropout"),
                             place=place).reshape(x.shape)
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(keep, x / keep_prob, 0.0)


def checkpoint(
    fn: Callable,
    *,
    policy=None,
    prevent_cse: bool = True,
    distribute_saved_activations: bool = False,
) -> Callable:
    """Activation recompute: ``fn`` wrapped so that its internals are
    recomputed in the backward, through ``remat.apply``
    (``torch.utils.checkpoint``, non-reentrant). ``policy`` names a remat
    policy (or is a ``remat.Policy``); None saves nothing, as
    ``jax.checkpoint(policy=None)`` does. Dropout inside replays the same
    masks, since its keys are inputs. The recompute runs inside the scopes
    of the forward: the autocast dtype (O1/O4), O6's quantized routing and
    the delayed fp8 scales in scope. Each is thread-local and the backward
    runs outside them, often on autograd's own thread, so ``remat.apply``
    captures the forward's and re-enters them there; a recompute in another
    dtype, or quantized otherwise, would not match what the forward saved.
    ``prevent_cse`` and ``distribute_saved_activations`` are accepted for
    parity and mean nothing on one device."""
    del prevent_cse, distribute_saved_activations
    return remat_apply(fn, "full" if policy is None else policy)


def checkpoint_apply(fn: Callable, *args, **kw):
    """The reference's call style: ``checkpoint(fn)(*args, **kw)``."""
    return checkpoint(fn)(*args, **kw)
