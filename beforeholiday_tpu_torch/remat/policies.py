"""Named, registrable rematerialization policies — counterpart of
``beforeholiday_tpu/remat/policies.py``.

Activation checkpointing trades backward-pass recompute for peak activation
memory (Chen et al. 2016; Korthikanti et al. 2022). PyTorch ships the
machinery (``torch.utils.checkpoint``, non-reentrant, and its selective
contexts); this module adds the naming layer, so that a policy travels as a
plain string through configs and pipeline schedules, with the JAX
package's names and errors.

Built-in policies:

* ``"none"``            — no remat: ``apply`` returns ``fn`` itself.
* ``"full"``            — ``torch.utils.checkpoint`` with nothing saved: only
                          the wrapped function's inputs survive and the whole
                          body is recomputed in the backward.
* ``"dots_saveable"``   — selective: save the outputs of the matrix products
                          (``aten.mm``, ``addmm``, ``bmm``, ``matmul`` and
                          ``_scaled_mm``), recompute the rest.
* ``"save_boundaries"`` — selective, by tag: save only the values named at
                          the repo's planted boundary tags (block outputs,
                          norm outputs, the attention context and the flash
                          ``lse``) and recompute everything between them.
* ``"zero3_regather"``  — save everything but the values tagged
                          ``zero3_gathered``, which the backward gathers
                          again (the ZeRO-3 engine plants the tag).

A tag names a value in one of two ways. :func:`checkpoint_name` is an
identity op registered with ``torch.library``, so that the selective
policy sees it; outside a region whose policy reads the tag it returns its
argument itself, no op and no copy, and inside one it returns a copy (a
custom op may not alias its input). A kernel registered as a custom op
instead names its outputs with :func:`tag_op`: ``ops.normalization``'s
``layer_norm_fwd`` is the norm output, ``ops.attention``'s ``flash_fwd``
the attention context and its ``lse``. Saving such an op's outputs also
skips its launch in the recompute, as JAX's policy keeps the flash
residuals.

The recompute runs where autograd's backward runs, outside the forward's
thread-local scopes, so :func:`apply` captures the O1/O4 autocast dtype,
O6's quantized routing and the delayed fp8 scales at the forward and
re-enters them for the recompute: a recompute in another dtype would not
match what the forward saved.

``register_policy`` adds named policies: a :class:`Policy`, a selective
checkpoint policy function ``(ctx, op, *args, **kwargs) -> CheckpointPolicy``
or a list of ops to save (what ``create_selective_checkpoint_contexts``
takes), or ``None`` for "save nothing".
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "BOUNDARY_TAGS",
    "DOT_OPS",
    "Policy",
    "TAG_ATTN_OUT",
    "TAG_BLOCK",
    "TAG_FLASH_LSE",
    "TAG_MOE_COMBINE",
    "TAG_MOE_DISPATCH",
    "TAG_NORM_OUT",
    "ZERO3_GATHERED_TAG",
    "apply",
    "available_policies",
    "checkpoint_name",
    "register_policy",
    "resolve",
    "tag_op",
]

# checkpoint_name tags planted in the library and the testing models, the
# JAX package's strings
TAG_BLOCK = "remat.block"          # transformer block output (testing/gpt, bert)
TAG_NORM_OUT = "remat.norm_out"    # fused_layer_norm / fused_rms_norm output
TAG_ATTN_OUT = "remat.attn_out"    # attention context (post-kernel, pre-proj)
TAG_FLASH_LSE = "remat.flash_lse"  # flash-attention log-sum-exp residual
TAG_MOE_DISPATCH = "remat.moe_dispatch"  # post-dispatch (E, C, D) activations
TAG_MOE_COMBINE = "remat.moe_combine"    # post-combine expert outputs

BOUNDARY_TAGS: Tuple[str, ...] = (
    TAG_BLOCK, TAG_NORM_OUT, TAG_ATTN_OUT, TAG_FLASH_LSE,
    TAG_MOE_DISPATCH, TAG_MOE_COMBINE,
)

# ZeRO-3 param residency: the gathered param leaves carry this tag, and the
# "zero3_regather" policy does not save them
ZERO3_GATHERED_TAG = "zero3_gathered"

_aten = torch.ops.aten
# the matrix products dots_saveable keeps, every overload (the card's bf16 x
# bf16 -> fp32 GEMM of ops/dense.py is mm's and addmm's ``.dtype``
# overload); ``matmul`` decomposes into mm or bmm before a dispatch mode
# sees it and is listed as the reference lists it
DOT_OPS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.matmul, _aten._scaled_mm)


# ------------------------------------------------------------------- tags


@torch.library.custom_op("beforeholiday::checkpoint_name", mutates_args=())
def _name_op(x: torch.Tensor, tag: str) -> torch.Tensor:
    return x.clone()


@_name_op.register_fake
def _(x, tag):
    return torch.empty_like(x)


def _name_setup(ctx, inputs, output):
    pass


def _name_backward(ctx, grad):
    return grad, None


_name_op.register_autograd(_name_backward, setup_context=_name_setup)
_NAME_PACKET = torch.ops.beforeholiday.checkpoint_name

# custom op (overload packet) -> the tags its outputs carry
_OP_TAGS: Dict[Any, Tuple[str, ...]] = {}


def tag_op(op, *tags: str) -> None:
    """Name the outputs of the custom op ``op`` (its overload packet, e.g.
    ``torch.ops.beforeholiday.flash_fwd``) with ``tags``: a policy that
    saves any of them saves the op's outputs."""
    _OP_TAGS[op] = tuple(tags)


class _Active(threading.local):
    def __init__(self):
        self.policies = []


_ACTIVE = _Active()


def checkpoint_name(x: torch.Tensor, tag: str) -> torch.Tensor:
    """Name ``x`` for the selective policies (``jax.ad_checkpoint.
    checkpoint_name``). Inside a region whose policy reads ``tag`` it is
    the op the policy sees (a copy of ``x``); anywhere else it returns
    ``x`` itself."""
    pols = _ACTIVE.policies
    if pols and isinstance(pols[-1], Policy) and pols[-1].reads(tag):
        return _name_op(x, tag)
    return x


def _tags_of(op, args) -> Tuple[str, ...]:
    """The tags ``op``'s outputs carry: a ``checkpoint_name``'s own, or a
    tagged kernel op's."""
    packet = getattr(op, "_overloadpacket", op)
    if packet is _NAME_PACKET:
        return (args[1],)
    return _OP_TAGS.get(packet, ())


# --------------------------------------------------------------- policies


class Policy:
    """A saveable policy for ``torch.utils.checkpoint``'s selective
    contexts: save the outputs of the ops in ``ops`` (overloads, or overload
    packets for all their overloads), and of the ops whose tags meet
    ``names``; with ``save_all``, save every op's outputs but those tagged in
    ``exclude_names``. Everything else is recomputed."""

    def __init__(self, *, ops: Iterable = (), names: Iterable[str] = (),
                 save_all: bool = False, exclude_names: Iterable[str] = ()):
        self.ops = frozenset(ops)
        self.names = frozenset(names)
        self.save_all = bool(save_all)
        self.exclude_names = frozenset(exclude_names)

    def reads(self, tag: str) -> bool:
        """Whether a value named ``tag`` changes what this policy saves."""
        return tag in self.names or tag in self.exclude_names

    def saves(self, op, args) -> bool:
        tags = _tags_of(op, args)
        if self.save_all:
            return not self.exclude_names.intersection(tags)
        return (op in self.ops or getattr(op, "_overloadpacket", None) in self.ops
                or bool(self.names.intersection(tags)))

    def __call__(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        return (CheckpointPolicy.MUST_SAVE if self.saves(op, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)


# sentinel for "do not wrap at all" — distinct from None ("save nothing")
_NO_REMAT = object()

_LOCK = threading.Lock()
# name -> Policy, a selective policy function or op list, None, or _NO_REMAT
_POLICIES: Dict[str, Any] = {}


def register_policy(name: str, policy: Any, *, overwrite: bool = False) -> None:
    """Register a named policy: a :class:`Policy`, a selective checkpoint
    policy function or list of ops, or ``None`` for "save nothing" (full
    remat)."""
    with _LOCK:
        if name in _POLICIES and not overwrite:
            raise ValueError(
                f"remat policy {name!r} already registered "
                "(pass overwrite=True to replace)"
            )
        _POLICIES[name] = policy


def available_policies() -> Tuple[str, ...]:
    """Sorted names of all registered policies."""
    with _LOCK:
        return tuple(sorted(_POLICIES))


def resolve(policy: Optional[str]) -> Any:
    """Name -> policy / None / no-remat sentinel. ``None`` and ``"none"``
    both mean "no remat". A non-string is taken to be a policy already and
    passes through (the escape hatch for one-off experiments)."""
    if policy is None:
        return _NO_REMAT
    if not isinstance(policy, str):
        return policy
    with _LOCK:
        try:
            return _POLICIES[policy]
        except KeyError:
            known = ", ".join(sorted(_POLICIES))
            raise ValueError(
                f"unknown remat policy {policy!r}; registered: {known}"
            ) from None


# ------------------------------------------------------------------ apply


def _saves(resolved) -> Callable:
    """``saves(op, args, kwargs)``: whether the selective policy saves the
    op's outputs."""
    if isinstance(resolved, Policy):
        return lambda op, args, kwargs: resolved.saves(op, args)
    if isinstance(resolved, (list, tuple)):
        ops = frozenset(resolved)
        return lambda op, args, kwargs: op in ops

    def ask(op, args, kwargs):
        ctx = torch.utils.checkpoint.SelectiveCheckpointContext(is_recompute=False)
        got = resolved(ctx, op, *args, **kwargs)
        return got in (True, CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_SAVE)

    return ask


class _SavedCounter(TorchDispatchMode):
    """While a memory reading is open: books the outputs a selective
    policy saves (``monitor.memory``'s CPU reading)."""

    def __init__(self, saves, keep):
        super().__init__()
        self.saves, self.keep = saves, keep

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.saves(func, args, kwargs):
            self.keep(out)
        return out


@contextlib.contextmanager
def _region(policy, *inner):
    """Enter the contexts ``inner`` (outermost first) with ``policy`` the
    innermost active one for :func:`checkpoint_name`."""
    _ACTIVE.policies.append(policy)
    try:
        with contextlib.ExitStack() as stack:
            for cm in inner:
                stack.enter_context(cm)
            yield
    finally:
        _ACTIVE.policies.pop()


def _scopes():
    """A factory of the forward's thread-local scopes (O1/O4 autocast, O6
    routing, the delayed fp8 scales), for the recompute to re-enter."""
    from beforeholiday_tpu_torch.ops._autocast import (
        autocast,
        autocast_dtype,
        quantized_compute,
        quantized_enabled,
    )
    from beforeholiday_tpu_torch.ops.quantized import active_scales, quantized_scope

    dtype, quantized, scales = autocast_dtype(), quantized_enabled(), active_scales()

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

    return again


def _policy_fn(resolved):
    """What ``create_selective_checkpoint_contexts`` takes."""
    if isinstance(resolved, (list, tuple)):
        return list(resolved)
    return resolved


def apply(
    fn: Callable,
    policy: Optional[str] = None,
    *,
    prevent_cse: bool = True,
    static_argnums: Tuple[int, ...] = (),
) -> Callable:
    """Wrap ``fn`` with the named remat policy.

    ``"none"``/``None`` returns ``fn`` unchanged. Everything else returns
    ``fn`` under ``torch.utils.checkpoint`` (non-reentrant): ``"full"``
    saves nothing, a selective policy saves what it names. The recompute
    re-enters the forward's autocast, O6 routing and fp8 scales.
    ``prevent_cse`` and ``static_argnums`` are accepted for parity (eager
    PyTorch has no CSE to prevent and no traced arguments)."""
    del prevent_cse, static_argnums
    resolved = resolve(policy)
    if resolved is _NO_REMAT:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from beforeholiday_tpu_torch.monitor import memory

        again = _scopes()
        keep = memory._saved_bytes_keeper()
        if keep is not None:
            keep((args, kwargs))  # the inputs the checkpoint keeps

        def contexts():
            if resolved is None:
                return _region(None), _region(None, again())
            fwd, rec = create_selective_checkpoint_contexts(_policy_fn(resolved))
            # the counter outside the caching mode: it sees each op's outputs
            count = (() if keep is None
                     else (_SavedCounter(_saves(resolved), keep),))
            return (_region(resolved, *count, fwd),
                    _region(resolved, again(), rec))

        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=contexts, **kwargs)

    return wrapped


# ---- built-ins -------------------------------------------------------------

register_policy("none", _NO_REMAT)
register_policy("full", None)  # save nothing
register_policy("dots_saveable", Policy(ops=DOT_OPS))
register_policy("save_boundaries", Policy(names=BOUNDARY_TAGS))
register_policy(
    # everything but the gathered param arena is saved: normal activation
    # residency, but params are gathered again in the backward
    "zero3_regather",
    Policy(save_all=True, exclude_names=(ZERO3_GATHERED_TAG,)),
)
