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
recomputed region draws the same masks again. The tensor-parallel and
data-parallel keys need the mesh's axes and raise until tensor parallelism
is ported.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from beforeholiday_tpu_torch.ops._autocast import (
    autocast,
    autocast_dtype,
    quantized_compute,
    quantized_enabled,
)
from beforeholiday_tpu_torch.ops.quantized import active_scales, quantized_scope
from beforeholiday_tpu_torch.ops._dispatch import resolve_device, resolve_impl
from beforeholiday_tpu_torch.ops.attention import (
    _check_key,
    dropout_keep_mask,
    philox4x32,
)

TENSOR_AXIS = "tensor"
DATA_AXIS = "data"
_MASK32 = 0xFFFFFFFF
# the hash counter's last two words for key derivation; masks count with
# (col, row, bh, 0), so a key's derived keys never reuse a mask's words
_FOLD_TAG, _SPLIT_TAG = 0x464F4C44, 0x53504C54


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


def model_parallel_seed(key: torch.Tensor, axis_name: str = TENSOR_AXIS):
    """Per tensor-parallel rank key: needs the mesh (not ported yet)."""
    raise NotImplementedError(
        "model_parallel_seed needs the tensor-parallel mesh, which is not "
        "ported yet")


def data_parallel_seed(key: torch.Tensor, axis_name: str = DATA_AXIS):
    """Per data-parallel rank key: needs the mesh (not ported yet)."""
    raise NotImplementedError(
        "data_parallel_seed needs the data-parallel mesh, which is not "
        "ported yet")


def dropout(
    key: Optional[torch.Tensor],
    x: torch.Tensor,
    rate: float,
    *,
    tp_distinct: bool = False,
    axis_name: str = TENSOR_AXIS,
    deterministic: bool = False,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Inverted dropout: survivors scaled by ``1 / (1 - rate)``, where the
    rate's complement is first rounded to x's dtype as JAX rounds a Python
    scalar to a bf16 operand. Identity at rate 0 or when ``deterministic``.
    ``impl`` picks the mask's kernel (K13) or its plain version."""
    if deterministic or rate == 0.0:
        return x
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if tp_distinct:
        raise NotImplementedError(
            "tp_distinct dropout needs the tensor-parallel mesh, which is not "
            "ported yet")
    if key is None:
        raise ValueError("dropout at rate > 0 needs a key")
    _check_key(key, x.device)
    shape = (1, 1, 1, *x.shape)[-3:] if x.ndim < 3 else (
        math.prod(x.shape[:-2]), *x.shape[-2:])
    keep = dropout_keep_mask(key, shape, rate,
                             impl=resolve_impl(impl, x)).reshape(x.shape)
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(keep, x / keep_prob, 0.0)


def checkpoint(
    fn: Callable,
    *,
    policy: Optional[Callable] = None,
    prevent_cse: bool = True,
    distribute_saved_activations: bool = False,
) -> Callable:
    """Activation recompute: ``fn`` wrapped so that its internals are
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant).
    Dropout inside replays the same masks, since its keys are inputs. The
    recompute runs inside the scopes of the forward: the autocast dtype
    (O1/O4), O6's quantized routing and the delayed fp8 scales in scope.
    Each is thread-local and the backward runs outside them, often on
    autograd's own thread, so the forward's are captured and re-entered
    there; a recompute in another dtype, or quantized otherwise, would not
    match what the forward saved. ``prevent_cse`` and
    ``distribute_saved_activations`` are accepted for parity and mean
    nothing on one device; a remat ``policy`` is not ported yet."""
    del prevent_cse, distribute_saved_activations
    if policy is not None:
        raise NotImplementedError(
            "checkpoint policies (beforeholiday_tpu.remat) are not ported yet")

    def wrapped(*args, **kw):
        dtype, quantized, scales = (autocast_dtype(), quantized_enabled(),
                                    active_scales())

        @contextlib.contextmanager
        def again():
            with contextlib.ExitStack() as stack:
                if dtype is not None:
                    stack.enter_context(autocast(dtype))
                if quantized:
                    stack.enter_context(quantized_compute())
                if scales is not None:
                    stack.enter_context(quantized_scope(*scales))
                yield

        def contexts():
            return contextlib.nullcontext(), again()

        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=contexts, **kw)

    return wrapped


def checkpoint_apply(fn: Callable, *args, **kw):
    """The reference's call style: ``checkpoint(fn)(*args, **kw)``."""
    return checkpoint(fn)(*args, **kw)
