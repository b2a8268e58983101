"""Per-op precision policy — counterpart of
``beforeholiday_tpu/ops/_autocast.py``, the O1/O4 "patch engine".

The reference's O1 patches ``torch.*`` and ``torch.nn.functional.*`` with
cast wrappers driven by its lists: FP16_FUNCS / BFLOAT16_FUNCS run in the
low precision, FP32_FUNCS stay fp32, CASTS promote to the widest input and
BANNED_FUNCS raise under fp16. The JAX package keeps that policy as an
explicit scope plus tagged ops, and so does this module: :func:`autocast`
sets the scope's compute dtype (fp16 for O1, bf16 for O4) in a thread-local
that the tags read, and ``amp``'s O1/O4 ``apply`` enters it.
``torch.autocast`` is not used: its policy is PyTorch's own op lists, and
this one must match the JAX package's op for op. An untagged op (ResNet's
``F.conv2d``, a residual add) runs in its inputs' dtype, as in JAX.

The scope also carries O6's routing flag: inside :func:`quantized_compute`
(or ``autocast(..., quantized=True)``) every ``ops.dense`` GEMM runs through
``ops.quantized.quantized_matmul``. The scope is thread-local, so autograd's
backward thread does not see it: an activation recompute that runs there
re-enters the forward's scope, flag and scales
(``transformer.tensor_parallel.random.checkpoint``).

:func:`cast_floats` is the one-time weight and input cast.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Optional

import torch

from beforeholiday_tpu_torch.ops.arena import is_namedtuple

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


class _State(threading.local):
    dtype: Optional[torch.dtype] = None
    quantized: bool = False


_state = _State()


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, str):
        dtype = _DTYPES.get(dtype)
    if dtype not in _DTYPES.values():
        raise ValueError(f"autocast takes one of {sorted(_DTYPES)}, got {dtype!r}")
    return dtype


@contextlib.contextmanager
def autocast(dtype, *, quantized: bool = False):
    """Activate the per-op cast policy with ``dtype`` as the low-precision
    compute type (fp16 for O1, bf16 for O4). ``quantized=True`` also turns
    on O6's quantized-matmul routing for the scope (see
    :func:`quantized_compute`); an enclosing scope's routing stays on.
    Scopes nest; leaving one, by an exception too, restores the enclosing
    one."""
    prev, prev_q = _state.dtype, _state.quantized
    _state.dtype = _as_dtype(dtype)
    _state.quantized = bool(quantized) or prev_q
    try:
        yield
    finally:
        _state.dtype, _state.quantized = prev, prev_q


@contextlib.contextmanager
def quantized_compute():
    """Route every ``ops.dense`` matmul inside the scope through
    ``ops.quantized.quantized_matmul`` (the O6 tier) without the per-op
    cast policy: O6 keeps O5's storage casts and swaps only the GEMMs'
    arithmetic."""
    prev_q = _state.quantized
    _state.quantized = True
    try:
        yield
    finally:
        _state.quantized = prev_q


def quantized_enabled() -> bool:
    """True inside :func:`quantized_compute` or ``autocast(...,
    quantized=True)``: the O6 routing predicate ``ops.dense`` reads."""
    return _state.quantized


def autocast_dtype() -> Optional[torch.dtype]:
    """The active low-precision dtype, or None outside autocast."""
    return _state.dtype


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor in a nest of dicts, lists and tuples to
    ``dtype``; other leaves pass through unchanged."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [cast_floats(v, dtype) for v in tree]
        return type(tree)(*vals) if is_namedtuple(tree) else type(tree)(vals)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _float_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield tree


def _widest_float(tree) -> Optional[torch.dtype]:
    """The promotion of the floating tensors' dtypes, by jnp's rule too:
    fp16 with bf16 promotes to fp32, not to whichever came first."""
    widest = None
    for leaf in _float_leaves(tree):
        widest = (leaf.dtype if widest is None
                  else torch.promote_types(widest, leaf.dtype))
    return widest


def half_function(fn: Callable) -> Callable:
    """Tag an op as low-precision under autocast (FP16_FUNCS /
    BFLOAT16_FUNCS): inside a scope its floating arguments are cast to the
    scope's dtype."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        dt = autocast_dtype()
        if dt is not None:
            args, kwargs = cast_floats(args, dt), cast_floats(kwargs, dt)
        return fn(*args, **kwargs)

    wrapped.__amp_list__ = "half"
    return wrapped


# the bf16 tag acts the same: the scope's dtype decides
bfloat16_function = half_function


def float_function(fn: Callable) -> Callable:
    """Tag an op as fp32-only under autocast (FP32_FUNCS: softmax, norms,
    losses, transcendentals): inside a scope its floating arguments are cast
    to fp32."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if autocast_dtype() is not None:
            args = cast_floats(args, torch.float32)
            kwargs = cast_floats(kwargs, torch.float32)
        return fn(*args, **kwargs)

    wrapped.__amp_list__ = "float"
    return wrapped


def promote_function(fn: Callable) -> Callable:
    """Tag a multi-input op to promote every floating input to the widest
    input dtype under autocast (the CASTS rule)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if autocast_dtype() is not None:
            widest = _widest_float((args, kwargs))
            if widest is not None:
                args = cast_floats(args, widest)
                kwargs = cast_floats(kwargs, widest)
        return fn(*args, **kwargs)

    wrapped.__amp_list__ = "promote"
    return wrapped


def banned_function(fn: Callable, name: str, reason: str) -> Callable:
    """Tag an op as unsafe under fp16 autocast: calling it inside an fp16
    scope raises, as the reference does for ``binary_cross_entropy``."""

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any):
        if autocast_dtype() == torch.float16:
            raise RuntimeError(
                f"amp does not work out-of-the-box with `{name}` under fp16: "
                f"{reason}")
        return fn(*args, **kwargs)

    wrapped.__amp_list__ = "banned"
    return wrapped
