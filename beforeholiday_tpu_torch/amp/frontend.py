"""amp frontend — opt levels and ``initialize`` for functional models;
counterpart of ``beforeholiday_tpu/amp/frontend.py``.

The same policy as the JAX package, as explicit dataflow: ``initialize``
returns cast params (norm leaves kept fp32 under ``keep_batchnorm_fp32``),
an ``apply`` wrapper that casts floating inputs to the compute dtype and
outputs to ``cast_model_outputs``, a master-weight optimizer wrapper, and
one :class:`LossScaler` per loss. :func:`scaled_value_and_grad` is the
functional ``amp.scale_loss``: ``(loss, grads, found_inf, new_scaler_state)``
with no host sync.

Opt levels O0-O5, as in the JAX package: O0 fp32; O2 (fp16) and O5 (bf16)
low-precision storage with fp32 masters and norm leaves, ``arena_native``
or on a tree; O3 fp16 storage and no masters; O1 (fp16) and O4 (bf16) fp32
storage whose ``apply`` casts the params, norm leaves kept, to the compute
dtype at every call and runs the model inside the ``autocast`` scope, so
the tagged ops follow the reference's lists (``ops._autocast``). O1 and O2
scale the loss dynamically. O6 is O5's storage with every ``ops.dense``
GEMM on the fp8 tier (``ops.quantized``): its ``apply`` runs the model
inside ``quantized_compute``, its scalers carry the amax history, and
:func:`scaled_value_and_grad` derives the step's delayed scales from that
history, provides them to the forward and backward through
``quantized_scope``, and rolls the step's (params, still-scaled grads) amax
observations back into it. ``tuned=True`` raises ``NotImplementedError``
(the autotuner is not ported). ``has_state`` models (ResNet's BN running stats)
pass their state through uncast in both directions, and
``scaled_value_and_grad(has_aux=True)`` returns the loss function's aux
output, and ``reduce_grads`` (DDP's reduction) runs on the still-scaled
grads before the unscale. Not ported either: ``arena_masters`` (the
optimizer's view path).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from beforeholiday_tpu_torch.amp.scaler import LossScaler
from beforeholiday_tpu_torch.ops import quantized as q8
from beforeholiday_tpu_torch.ops._autocast import autocast, quantized_compute
from beforeholiday_tpu_torch.ops._autocast import cast_floats as _cast_floats
from beforeholiday_tpu_torch.ops.arena import (
    PackedParams,
    tree_flatten,
    tree_map,
    tree_paths,
    tree_unflatten,
)
from beforeholiday_tpu_torch.optimizers.fused import MasterWeights


@dataclasses.dataclass(frozen=True)
class Properties:
    """Opt-level property set."""

    enabled: bool = True
    opt_level: str = "O0"
    cast_model_type: Optional[torch.dtype] = None  # storage dtype for params
    patch_torch_functions: bool = False  # compute-dtype casting w/ fp32 storage
    patch_torch_functions_type: Optional[torch.dtype] = None
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Any = 1.0  # "dynamic" | float
    quantized: bool = False  # O6

    @property
    def compute_dtype(self) -> torch.dtype:
        """dtype arithmetic runs in: patched-functions type, else storage type."""
        if self.patch_torch_functions and self.patch_torch_functions_type is not None:
            return self.patch_torch_functions_type
        return self.cast_model_type or torch.float32


opt_levels: Dict[str, Properties] = {
    "O0": Properties(opt_level="O0", cast_model_type=torch.float32,
                     master_weights=False, loss_scale=1.0),
    "O1": Properties(opt_level="O1", patch_torch_functions=True,
                     patch_torch_functions_type=torch.float16,
                     loss_scale="dynamic"),
    "O2": Properties(opt_level="O2", cast_model_type=torch.float16,
                     keep_batchnorm_fp32=True, master_weights=True,
                     loss_scale="dynamic"),
    "O3": Properties(opt_level="O3", cast_model_type=torch.float16,
                     keep_batchnorm_fp32=False, master_weights=False,
                     loss_scale=1.0),
    "O4": Properties(opt_level="O4", patch_torch_functions=True,
                     patch_torch_functions_type=torch.bfloat16, loss_scale=1.0),
    "O5": Properties(opt_level="O5", cast_model_type=torch.bfloat16,
                     keep_batchnorm_fp32=True, master_weights=True,
                     loss_scale=1.0),
    "O6": Properties(opt_level="O6", cast_model_type=torch.bfloat16,
                     keep_batchnorm_fp32=True, master_weights=True,
                     loss_scale="dynamic", quantized=True),
}


def _default_keep_fp32(path: Tuple[Any, ...]) -> bool:
    """``keep_batchnorm_fp32`` by name: norm-layer parameters stay fp32
    (``ln1_scale``, ``lnf_bias``, ``*norm*``, ``bn*``)."""
    for part in path:
        low = str(part).lower()
        if ("norm" in low or low.startswith("bn") or low.endswith("bn")
                or low.startswith("ln")):
            return True
    return False


def _cast_leaves(tree, dtype: torch.dtype, keep=None, kept=None):
    """``tree`` with its floating leaves cast to ``dtype``, but those whose
    path ``keep`` picks: they go to ``kept``, or stay as they are."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for path, leaf in zip(tree_paths(tree), leaves):
        if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
            out.append(leaf)
        elif keep is not None and keep(path):
            out.append(leaf if kept is None else leaf.to(kept))
        else:
            out.append(leaf.to(dtype))
    return tree_unflatten(treedef, out)


def _cast_params(params, policy: Properties, keep_fp32_mask):
    if policy.cast_model_type is None:
        return params
    keep = keep_fp32_mask if keep_fp32_mask is not None else _default_keep_fp32
    return _cast_leaves(params, policy.cast_model_type,
                        keep if policy.keep_batchnorm_fp32 else None, torch.float32)


@dataclasses.dataclass
class AmpModel:
    """What ``initialize`` returns: the functional (model, optimizer) pair."""

    policy: Properties
    apply: Callable  # wrapped apply: casts inputs/outputs per policy
    params: Any  # storage-dtype params (a PackedParams when arena_native)
    optimizer: Any  # possibly MasterWeights-wrapped
    scaler: LossScaler  # scalers[0]
    scalers: Tuple[LossScaler, ...] = ()  # one per loss

    def __post_init__(self):
        if not self.scalers:
            self.scalers = (self.scaler,)

    def state_dict(self, scaler_state) -> Dict[str, Any]:
        """Scaler checkpoint, one ``loss_scaler{i}`` entry per loss. Reads
        the scaler state back to the host: call it outside the step.

        A ``guard.StepGuard`` state (recognized by its ``health`` key) may
        stand in for a scaler state: its scaler serializes as
        ``loss_scaler{i}`` and its health counters ride along as
        ``health{i}``. The rollback snapshot is not serialized (it is
        model-sized; ``StepGuard.load_state_dict`` re-seeds it)."""
        states = (list(scaler_state) if isinstance(scaler_state, (list, tuple))
                  else [scaler_state])
        if len(states) != len(self.scalers):
            raise ValueError(
                f"expected {len(self.scalers)} scaler states, got {len(states)}"
            )
        out: Dict[str, Any] = {}
        for i, (s, st) in enumerate(zip(self.scalers, states)):
            if isinstance(st, dict) and "health" in st:
                out[f"loss_scaler{i}"] = s.state_dict(st["scaler"])
                out[f"health{i}"] = {k: int(v) for k, v in st["health"].items()}
            else:
                out[f"loss_scaler{i}"] = s.state_dict(st)
        return out

    def load_state_dict(self, state_dict, device=None):
        """Inverse of :meth:`state_dict`: the single scaler state, or the
        list of per-loss states. An entry saved with a ``health{i}`` sibling
        comes back guard-shaped (``{"scaler": ..., "health": ...}``, no
        snapshot)."""
        out = []
        for i, s in enumerate(self.scalers):
            sstate = s.load_state_dict(state_dict[f"loss_scaler{i}"], device=device)
            if f"health{i}" in state_dict:
                dev = sstate["scale"].device
                out.append({"scaler": sstate, "health": {
                    k: torch.tensor(int(v), dtype=torch.int32, device=dev)
                    for k, v in state_dict[f"health{i}"].items()}})
            else:
                out.append(sstate)
        return out[0] if len(out) == 1 else out


def initialize(
    apply_fn: Callable,
    params: Any,
    optimizer: Any = None,
    opt_level: Optional[str] = None,
    *,
    tuned: bool = False,
    cast_model_outputs: Optional[torch.dtype] = torch.float32,
    keep_batchnorm_fp32: Optional[bool] = None,
    master_weights: Optional[bool] = None,
    loss_scale: Optional[Any] = None,
    keep_fp32_mask: Optional[Callable] = None,
    has_state: bool = False,
    num_losses: int = 1,
    arena_native: bool = False,
) -> AmpModel:
    """Apply an opt-level policy to ``(apply_fn, params, optimizer)``.

    ``keep_batchnorm_fp32``/``master_weights``/``loss_scale`` override the
    level's defaults. ``arena_native=True`` stores the cast params as
    :class:`PackedParams` (one flat arena per dtype): ``apply`` unpacks
    views, :func:`scaled_value_and_grad` returns gradient arenas, and the
    master-weight step runs one fused kernel per arena with no packing.

    ``has_state=True`` declares ``apply_fn(params, model_state, *inputs) ->
    (out, new_model_state)``: model buffers such as BN running stats, passed
    through uncast in both directions."""
    if tuned:
        raise NotImplementedError(
            "tuned=True needs the autotuner (beforeholiday_tpu.tune), which "
            "is not ported yet; pass opt_level explicitly")
    if opt_level is None:
        opt_level = "O5"
    if opt_level not in opt_levels:
        raise RuntimeError(
            f"Unexpected optimization level {opt_level}. Options are 'O0', "
            "'O1', 'O2', 'O3', 'O4', 'O5', 'O6'."
        )
    policy = opt_levels[opt_level]
    overrides = {}
    if keep_batchnorm_fp32 is not None:
        overrides["keep_batchnorm_fp32"] = keep_batchnorm_fp32
    if master_weights is not None:
        overrides["master_weights"] = master_weights
    if loss_scale is not None:
        overrides["loss_scale"] = loss_scale
    if overrides:
        policy = dataclasses.replace(policy, **overrides)

    cast_params = _cast_params(params, policy, keep_fp32_mask)
    if arena_native:
        if policy.patch_torch_functions or (
                optimizer is not None and not policy.master_weights):
            # without MasterWeights a raw optimizer would take the two
            # arenas for two leaves, its per-tensor terms per arena
            raise ValueError(
                "arena_native requires a master-weights opt level (O2/O5, or "
                f"master_weights=True); {policy.opt_level} with "
                f"master_weights={policy.master_weights} would hand "
                "PackedParams to the raw optimizer"
            )
        cast_params = PackedParams.pack(cast_params)
    amp_apply = make_apply(policy, apply_fn,
                           cast_model_outputs=cast_model_outputs,
                           has_state=has_state, keep_fp32_mask=keep_fp32_mask)
    opt = optimizer
    if opt is not None and policy.master_weights:
        opt = MasterWeights(opt)
    if num_losses < 1:
        raise ValueError(f"num_losses must be >= 1, got {num_losses}")
    scalers = tuple(LossScaler(loss_scale=policy.loss_scale,
                               quantized=policy.quantized)
                    for _ in range(num_losses))
    return AmpModel(policy=policy, apply=amp_apply, params=cast_params,
                    optimizer=opt, scaler=scalers[0], scalers=scalers)


def make_apply(policy: Properties, apply_fn: Callable, *,
               cast_model_outputs: Optional[torch.dtype] = torch.float32,
               has_state: bool = False,
               keep_fp32_mask: Optional[Callable] = None) -> Callable:
    """Wrap ``apply_fn`` with the policy's input and output casts (the
    params are used as given: they are already in storage dtype), for
    example an eval-mode forward sharing an ``AmpModel``'s params. With
    ``has_state`` the model state (the first input) and the new state in
    the output pass through uncast.

    At O1/O4 (``patch_torch_functions``) the fp32-stored params are cast to
    the compute dtype at every call, the leaves ``keep_fp32_mask`` (default:
    the norm leaves) picks kept fp32, and ``apply_fn`` runs inside
    ``autocast(compute_dtype)``: the tagged ops then follow the reference's
    lists (norms and losses re-promote to fp32, dense and attention stay low
    precision). At O6 (``quantized``) ``apply_fn`` runs inside
    ``quantized_compute``: O5's casts, the dense GEMMs on the fp8 tier."""
    compute_dtype = policy.compute_dtype
    keep = keep_fp32_mask if keep_fp32_mask is not None else _default_keep_fp32

    def amp_apply(p, *inputs, **kwinputs):
        if isinstance(p, PackedParams):
            p = p.unpack()  # views of the arenas, no copy
        if has_state:
            model_state, *inputs = inputs
        if policy.patch_torch_functions:
            # norm leaves stay fp32: O1 keeps the model's weights fp32 and
            # the FP32_FUNCS read them uncast; casting gamma/beta down first
            # would round them before float_function re-promotes them
            p = _cast_leaves(p, compute_dtype, keep)
            scope = autocast(compute_dtype, quantized=policy.quantized)
        elif policy.quantized:
            scope = quantized_compute()
        else:
            scope = contextlib.nullcontext()
        inputs = _cast_floats(inputs, compute_dtype)
        kwinputs = _cast_floats(kwinputs, compute_dtype)
        with scope:
            if has_state:
                out, new_state = apply_fn(p, model_state, *inputs, **kwinputs)
            else:
                out = apply_fn(p, *inputs, **kwinputs)
        if cast_model_outputs is not None:
            out = _cast_floats(out, cast_model_outputs)
        return (out, new_state) if has_state else out

    return amp_apply


def differentiate(objective: Callable, params) -> Tuple[Any, Any]:
    """Autograd of ``objective(p) -> (value, out)`` with respect to
    ``params``; returns ``(out, grads)``. At a :class:`PackedParams` the
    grads are born flat: the objective reads leaf views whose ``.grad`` are
    views of one zeroed gradient arena per dtype
    (:meth:`PackedParams.grad_leaves`), and ``grads`` is a
    :class:`PackedParams` of those arenas. Any other tree gets a tree of
    grads (zeros for a leaf the objective does not use)."""
    if isinstance(params, PackedParams):
        grads = params.zeros_like()
        value, out = objective(params.grad_leaves(grads))
        value.backward()
        return out, grads
    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    value, out = objective(tree_unflatten(treedef, leaves))
    got = torch.autograd.grad(value, leaves, allow_unused=True)
    return out, tree_unflatten(treedef, [
        torch.zeros_like(x) if g is None else g for x, g in zip(leaves, got)])


def detach_tree(tree):
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
                    tree)


def scaled_grads(loss_fn: Callable, scaler: LossScaler, params, scaler_state,
                 args, kw, *, has_aux: bool = False,
                 reduce_grads: Optional[Callable] = None):
    """The scaled backward shared by :func:`scaled_value_and_grad` and
    ``guard.StepGuard.value_and_grad``: ``(loss, aux, grads, amax)`` with
    the grads of ``scale * loss`` still scaled, ``reduce_grads`` applied.

    With a quantized scaler (O6) the step's delayed fp8 scales come from
    the state's amax history and are in scope for the forward and the
    backward; ``amax`` is then this step's (weight, grad) observation pair,
    the params' amax (the tensors the forward quantized) and the reduced,
    still-scaled grads' (the scaling regime the backward quantized its
    cotangents in), for the scaler's update. Otherwise ``amax`` is None."""

    def objective(p):
        res = loss_fn(p, *args, **kw)
        loss, aux = res if has_aux else (res, None)
        return scaler.scale_loss(loss, scaler_state), (loss, aux)

    scale_w, scale_g = scaler.quantized_scales(scaler_state)
    scope = (contextlib.nullcontext() if scale_w is None
             else q8.quantized_scope(scale_w, scale_g))
    with scope:
        (loss, aux), grads = differentiate(objective, params)
    if reduce_grads is not None:
        grads = reduce_grads(grads)
    amax = None
    if scale_w is not None:
        amax = (q8.amax_of_tree(params), q8.amax_of_tree(grads))
    return loss.detach(), detach_tree(aux), grads, amax


def scaled_value_and_grad(loss_fn: Callable, scaler: LossScaler, *,
                          has_aux: bool = False, impl=None,
                          reduce_grads: Optional[Callable] = None):
    """The functional ``amp.scale_loss``. Returns ``f(params, scaler_state,
    *args) -> (loss, grads, found_inf, new_scaler_state)``: autograd of
    ``scale * loss``, grads unscaled to fp32 by K5 with its overflow flag,
    and the scaler state advanced. Thread ``found_inf`` into
    ``optimizer.step`` for the skip step. With ``has_aux`` the loss function
    returns ``(loss, aux)`` and ``f`` returns ``(loss, aux, grads,
    found_inf, new_scaler_state)``, the aux tensors detached.

    ``reduce_grads`` (``DistributedDataParallel.reduce``) runs on the
    still-scaled grads before K5's unscale, as in the JAX package, so the
    overflow flag sees the reduced grads and every rank takes the same skip
    decision. At O6 the step's fp8 scales and amax observations are
    threaded as :func:`scaled_grads` says, and the observations roll into
    the history in the new state.

    At a :class:`PackedParams` argument the grads are born flat (see
    :func:`differentiate`) and come back a :class:`PackedParams` of fp32
    arenas. Any other params tree gets a tree of fp32 grads. Nothing here
    reads a device value back to the host.
    """

    def wrapped(params, scaler_state, *args, **kw):
        loss, aux, grads, amax = scaled_grads(
            loss_fn, scaler, params, scaler_state, args, kw, has_aux=has_aux,
            reduce_grads=reduce_grads)
        grads, found_inf = scaler.unscale(grads, scaler_state, impl=impl)
        new_state = scaler.update(scaler_state, found_inf, amax=amax)
        if has_aux:
            return loss, aux, grads, found_inf, new_state
        return loss, grads, found_inf, new_state

    return wrapped
