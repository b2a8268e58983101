"""Fused optimizers — counterpart of ``beforeholiday_tpu/optimizers/fused.py``
(the part the O5 training steps run: ``FusedAdam``, ``FusedLAMB``,
``MasterWeights`` and ``FusedMixedPrecisionLamb``).

The state API is the JAX one::

    opt = FusedAdam(lr=1e-3)
    state = opt.init(params)
    params, state = opt.step(params, grads, state, found_inf=found_inf)

with one difference the port makes on purpose: the arena-resident path
(:meth:`FusedAdam.step_flat`, :meth:`MasterWeights.step` on
:class:`PackedParams`) updates the master, moment and model arenas IN PLACE
through kernel K6 (Adam) or K7-K9 (LAMB), so the returned arenas are the
ones passed in and the old state is consumed (the JAX package aliases its
TPU kernel's buffers the same way). The list API (:meth:`FusedAdam.step` on a tree) packs, updates the
packed copies and returns new tensors. The step count is a device tensor
and ``found_inf`` holds it, so a skipped step changes nothing and no value
is read back to the host.

State is fp32 (the kernels update fp32 arenas). Not ported yet: the other
optimizers, the view path (``_step_views``, ``MasterWeights(arena=True)`` on
a tree, so ``arena_masters``), ``step_in_backward`` and ``state_dtype``.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from beforeholiday_tpu_torch.ops import multi_tensor as mt
from beforeholiday_tpu_torch.ops.arena import (
    PackedParams,
    tree_flatten,
    tree_map,
    tree_paths,
    tree_unflatten,
)

Mask = Union[None, Any, Callable[[Tuple[Any, ...]], bool]]


def _leaf_flags(mask: Mask, params) -> List[bool]:
    """Resolve a no-weight-decay mask to one bool per leaf (True = NO decay)."""
    n = len(tree_flatten(params)[0])
    if mask is None:
        return [False] * n
    if callable(mask):
        return [bool(mask(path)) for path in tree_paths(params)]
    flags = [bool(x) for x in tree_flatten(mask)[0]]
    if len(flags) != n:
        raise ValueError(
            f"no_weight_decay_mask has {len(flags)} leaves but params has {n}; "
            "the mask must mark every leaf (or be a callable on paths)"
        )
    return flags


def _buckets(pleaves, gleaves, nowd_flags) -> Dict[tuple, List[int]]:
    if not (len(pleaves) == len(gleaves) == len(nowd_flags)):
        raise ValueError(
            f"params/grads leaf mismatch: {len(pleaves)} vs {len(gleaves)}"
        )
    out: Dict[tuple, List[int]] = {}
    for i, (p, g, nowd) in enumerate(zip(pleaves, gleaves, nowd_flags)):
        out.setdefault((p.dtype, g.dtype, nowd), []).append(i)
    return out


def _gather(leaves, idx):
    return [leaves[i] for i in idx]


def _scatter(dst: list, idx, values):
    for i, v in zip(idx, values):
        dst[i] = v


class _FusedOptimizer:
    """Shared bucketing and step-count machinery."""

    def __init__(self, *, no_weight_decay_mask: Mask = None):
        self.no_weight_decay_mask = no_weight_decay_mask

    def _state_keys(self) -> Sequence[str]:
        raise NotImplementedError

    def init(self, params) -> Dict[str, Any]:
        """Zero state per leaf and a device step count."""
        state = {
            key: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
            for key in self._state_keys()
        }
        device = tree_flatten(params)[0][0].device
        state["step"] = torch.zeros((), dtype=torch.int32, device=device)
        return state

    def _next_step(self, state, found_inf):
        """The step count advances only on unskipped steps."""
        step = state["step"]
        if found_inf is None:
            return step + 1
        return torch.where(torch.as_tensor(found_inf) != 0, step, step + 1)

    # ---- arena-resident (flat) API: uniform weight decay over one arena

    def init_flat(self, flat_params: torch.Tensor) -> Dict[str, Any]:
        """State for one pre-flattened parameter arena."""
        if type(self).step_flat is _FusedOptimizer.step_flat:
            raise NotImplementedError(
                f"{type(self).__name__} has no flat-arena step; use the "
                "list-based init()/step()"
            )
        if self.no_weight_decay_mask is not None:
            raise ValueError(
                "no_weight_decay_mask is per-leaf; the flat-arena path applies "
                "one decay to the whole arena — use the list-based step()"
            )
        state = {key: torch.zeros(flat_params.shape, dtype=torch.float32,
                                  device=flat_params.device)
                 for key in self._state_keys()}
        state["step"] = torch.zeros((), dtype=torch.int32,
                                    device=flat_params.device)
        return state

    def step_flat(self, flat_params, flat_grads, state, *, spec=None,
                  found_inf=None, grad_scale=1.0, lr=None, model_copy=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no flat-arena step; use step()"
        )


class FusedAdam(_FusedOptimizer):
    """Fused Adam/AdamW on kernel K6 (``ops.multi_tensor.adam_flat``).
    ``impl``: None (kernel on CUDA tensors, plain version on CPU ones),
    ``"kernel"`` or ``"torch"``."""

    def __init__(self, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, *, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, bias_correction: bool = True,
                 no_weight_decay_mask: Mask = None, impl: Optional[str] = None):
        super().__init__(no_weight_decay_mask=no_weight_decay_mask)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.impl = impl

    def _state_keys(self):
        return ("exp_avg", "exp_avg_sq")

    def _hyper(self, lr):
        return dict(lr=self.lr if lr is None else lr, beta1=self.betas[0],
                    beta2=self.betas[1], eps=self.eps,
                    adam_w_mode=self.adam_w_mode,
                    bias_correction=self.bias_correction, impl=self.impl)

    def step(self, params, grads, state, *, found_inf=None, grad_scale=1.0,
             lr=None):
        """List API: one fused call per (param dtype, grad dtype, decay)
        bucket; returns new params and state trees."""
        pleaves, treedef = tree_flatten(params)
        gleaves = tree_flatten(grads)[0]
        mleaves = tree_flatten(state["exp_avg"])[0]
        vleaves = tree_flatten(state["exp_avg_sq"])[0]
        nowd = _leaf_flags(self.no_weight_decay_mask, params)
        step_no = self._next_step(state, found_inf)
        new_p, new_m, new_v = list(pleaves), list(mleaves), list(vleaves)
        for (_, _, no_decay), idx in _buckets(pleaves, gleaves, nowd).items():
            p2, m2, v2 = mt.multi_tensor_adam(
                _gather(gleaves, idx), _gather(pleaves, idx),
                _gather(mleaves, idx), _gather(vleaves, idx),
                step=step_no, weight_decay=0.0 if no_decay else self.weight_decay,
                grad_scale=grad_scale, found_inf=found_inf, **self._hyper(lr),
            )
            _scatter(new_p, idx, p2)
            _scatter(new_m, idx, m2)
            _scatter(new_v, idx, v2)

        def unflat(leaves):
            return tree_unflatten(treedef, leaves)

        return unflat(new_p), {"exp_avg": unflat(new_m),
                               "exp_avg_sq": unflat(new_v), "step": step_no}

    def step_flat(self, flat_params, flat_grads, state, *, spec=None,
                  found_inf=None, grad_scale=1.0, lr=None, model_copy=None):
        """One K6 pass over pre-flattened arenas, in place on ``flat_params``
        and the moments. ``model_copy`` receives the new params in its own
        dtype in the same pass; ``spec`` is accepted and unused (Adam has no
        per-tensor term). Returns ``(flat_params, state)`` or
        ``(flat_params, state, model_copy)``."""
        step_no = self._next_step(state, found_inf)
        outs = mt.adam_flat(
            flat_grads, flat_params, state["exp_avg"], state["exp_avg_sq"],
            step=step_no, weight_decay=self.weight_decay,
            grad_scale=grad_scale, found_inf=found_inf, model_copy=model_copy,
            **self._hyper(lr),
        )
        new_state = {"exp_avg": outs[1], "exp_avg_sq": outs[2], "step": step_no}
        if len(outs) == 3:
            return outs[0], new_state
        return outs[0], new_state, outs[3]


class FusedLAMB(_FusedOptimizer):
    """Fused LAMB with in-step global-grad-norm clipping on kernels K7
    (stage 1), K8 (trust-ratio update) and K9 (global sum of squares), through
    ``ops.multi_tensor.lamb_flat``. ``impl``: None (kernels on CUDA tensors,
    plain versions on CPU ones), ``"kernel"`` or ``"torch"``."""

    def __init__(self, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, *, weight_decay: float = 0.01,
                 bias_correction: bool = True, grad_averaging: bool = True,
                 adam_w_mode: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, no_weight_decay_mask: Mask = None,
                 impl: Optional[str] = None):
        super().__init__(no_weight_decay_mask=no_weight_decay_mask)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.grad_averaging = grad_averaging
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.impl = impl

    def _state_keys(self):
        return ("exp_avg", "exp_avg_sq")

    def _hyper(self, lr):
        return dict(lr=self.lr if lr is None else lr, beta1=self.betas[0],
                    beta2=self.betas[1], eps=self.eps,
                    bias_correction=self.bias_correction,
                    grad_averaging=self.grad_averaging,
                    mode=1 if self.adam_w_mode else 0,
                    max_grad_norm=self.max_grad_norm,
                    use_nvlamb=self.use_nvlamb, impl=self.impl)

    def step(self, params, grads, state, *, found_inf=None, grad_scale=1.0,
             lr=None):
        """List API: one global grad norm over every leaf (K9), then one
        fused call per (param dtype, grad dtype, decay) bucket; returns new
        params and state trees."""
        pleaves, treedef = tree_flatten(params)
        mleaves = tree_flatten(state["exp_avg"])[0]
        vleaves = tree_flatten(state["exp_avg_sq"])[0]
        nowd = _leaf_flags(self.no_weight_decay_mask, params)
        step_no = self._next_step(state, found_inf)
        # the inverse loss scale is folded in before the clip norm
        gleaves = [g.float() * mt._as_float(grad_scale)
                   for g in tree_flatten(grads)[0]]
        gnorm, _ = mt.multi_tensor_l2norm(gleaves, impl=self.impl)
        new_p, new_m, new_v = list(pleaves), list(mleaves), list(vleaves)
        for (_, _, no_decay), idx in _buckets(pleaves, gleaves, nowd).items():
            p2, m2, v2 = mt.multi_tensor_lamb(
                _gather(gleaves, idx), _gather(pleaves, idx),
                _gather(mleaves, idx), _gather(vleaves, idx),
                step=step_no, weight_decay=0.0 if no_decay else self.weight_decay,
                global_grad_norm=gnorm, found_inf=found_inf, **self._hyper(lr),
            )
            _scatter(new_p, idx, p2)
            _scatter(new_m, idx, m2)
            _scatter(new_v, idx, v2)

        def unflat(leaves):
            return tree_unflatten(treedef, leaves)

        return unflat(new_p), {"exp_avg": unflat(new_m),
                               "exp_avg_sq": unflat(new_v), "step": step_no}

    def step_flat(self, flat_params, flat_grads, state, *, spec=None,
                  found_inf=None, grad_scale=1.0, lr=None,
                  model_copy_dtype=None, global_grad_norm=None,
                  model_copy=None):
        """One LAMB step over pre-flattened arenas, in place on
        ``flat_params`` and the moments. ``spec`` (the arena's
        :class:`ArenaSpec`) gives the per-tensor trust ratios.
        ``global_grad_norm``: pass the norm over every arena when the model
        spans several (``MasterWeights`` does); the default, this arena's own
        norm, is right only when the arena is the whole model.
        ``model_copy`` (or a new arena of ``model_copy_dtype``) receives the
        new params in the same pass. Returns ``(flat_params, state)`` or
        ``(flat_params, state, model_copy)``."""
        if spec is None:
            raise ValueError("FusedLAMB.step_flat needs the ArenaSpec for its "
                             "per-tensor trust-ratio norms")
        step_no = self._next_step(state, found_inf)
        gf = flat_grads
        # fold the inverse loss scale before the clip norm; an fp32 arena
        # with the default scale of 1.0 is used as it is (x * 1.0 == x)
        if not (isinstance(grad_scale, float) and grad_scale == 1.0
                and gf.dtype == torch.float32):
            gf = gf.float() * mt._as_float(grad_scale)
        outs = mt.lamb_flat(
            gf, flat_params, state["exp_avg"], state["exp_avg_sq"], spec,
            step=step_no, weight_decay=self.weight_decay,
            global_grad_norm=global_grad_norm, found_inf=found_inf,
            model_copy_dtype=model_copy_dtype, model_copy=model_copy,
            **self._hyper(lr),
        )
        new_state = {"exp_avg": outs[1], "exp_avg_sq": outs[2], "step": step_no}
        if len(outs) == 3:
            return outs[0], new_state
        return outs[0], new_state, outs[3]


def supports_flat_step(opt) -> bool:
    """True when ``opt`` can run the arena-resident flat path: it overrides
    ``step_flat`` and carries no per-leaf decay mask."""
    return (
        isinstance(opt, _FusedOptimizer)
        and type(opt).step_flat is not _FusedOptimizer.step_flat
        and opt.no_weight_decay_mask is None
    )


class MasterWeights:
    """fp32 master-weight optimizer wrapper (amp O2/O5).

    ``init`` snapshots fp32 masters from the model params; ``step`` updates
    the masters with fp32 grads and writes each model leaf's dtype back. On
    :class:`PackedParams` (``amp.initialize(..., arena_native=True)``) the
    masters and the inner state are one flat arena per model dtype, and one
    K6 pass per arena updates master and moments in place and writes the
    model copy straight into the model arena the forward reads. Any other
    params tree keeps tree-shaped masters and state (the list API)."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        if isinstance(params, PackedParams):
            masters = tuple(a.to(torch.float32, copy=True) for a in params.arenas)
            return {"inner": tuple(self.inner.init_flat(m) for m in masters),
                    "master": masters}
        master = tree_map(lambda p: p.to(torch.float32, copy=True), params)
        return {"inner": self.inner.init(master), "master": master}

    def step(self, params, grads, state, *, found_inf=None, grad_scale=1.0, **kw):
        if isinstance(params, PackedParams):
            return self._step_packed(params, grads, state, found_inf=found_inf,
                                     grad_scale=grad_scale, **kw)
        grads32 = tree_map(lambda g: g.float(), grads)
        new_master, new_inner = self.inner.step(
            state["master"], grads32, state["inner"], found_inf=found_inf,
            grad_scale=grad_scale, **kw)
        mleaves = tree_flatten(new_master)[0]
        pleaves, treedef = tree_flatten(params)
        new_params = tree_unflatten(
            treedef, [m.to(p.dtype) for m, p in zip(mleaves, pleaves)])
        return new_params, {"inner": new_inner, "master": new_master}

    def _global_norm_extra(self, flat_grads, grad_scale):
        """Norm-clipping optimizers (LAMB) need ONE global grad norm across
        every dtype bucket: per-bucket norms would clip each bucket by its
        own magnitude. The norm is the square root of the sum of K9 over
        each gradient arena, ``grad_scale`` folded into every element."""
        if "global_grad_norm" not in inspect.signature(
                self.inner.step_flat).parameters:
            return {}
        impl = getattr(self.inner, "impl", None)
        scale = None if (isinstance(grad_scale, float)
                         and grad_scale == 1.0) else grad_scale
        total = None
        for g in flat_grads:
            sq, _ = mt.l2norm_sq(g, scale=scale, impl=impl)
            total = sq if total is None else total + sq
        return {"global_grad_norm": torch.sqrt(total)}

    def _step_packed(self, params, grads, state, *, found_inf=None,
                     grad_scale=1.0, **kw):
        """Arena-native step: model and grads are already flat. One fused
        pass per dtype bucket, given the bucket's ``ArenaSpec``, updates the
        master and moments in place and writes the model arena (bf16, or
        fp32 for the kept-fp32 bucket) in the same pass. Returns ``params``
        itself, its arenas updated."""
        if not isinstance(grads, PackedParams):
            raise ValueError(
                "packed step needs PackedParams grads (scaled_value_and_grad "
                "at a PackedParams argument returns them)"
            )
        if grads.layout != params.layout:
            raise ValueError("params/grads PackedParams layouts differ")
        masters, inners = [], []
        extra = self._global_norm_extra(grads.arenas, grad_scale)
        for b, model_arena in enumerate(params.arenas):
            outs = self.inner.step_flat(
                state["master"][b], grads.arenas[b], state["inner"][b],
                spec=params.layout.specs[b], found_inf=found_inf,
                grad_scale=grad_scale, model_copy=model_arena, **extra, **kw)
            masters.append(outs[0])
            inners.append(outs[1])
        return params, {"inner": tuple(inners), "master": tuple(masters)}

    def master_params(self, state):
        """The master leaves."""
        return tree_flatten(state["master"])[0]


class FusedMixedPrecisionLamb(MasterWeights):
    """LAMB over fp32 master state with low-precision model params: exactly
    ``MasterWeights(FusedLAMB(...))``; ``step`` takes the amp scaler's
    ``grad_scale``/``found_inf`` directly."""

    def __init__(self, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, *, weight_decay: float = 0.01,
                 bias_correction: bool = True, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                 no_weight_decay_mask: Mask = None, impl: Optional[str] = None):
        super().__init__(FusedLAMB(
            lr, betas, eps, weight_decay=weight_decay,
            bias_correction=bias_correction, grad_averaging=grad_averaging,
            adam_w_mode=True, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, no_weight_decay_mask=no_weight_decay_mask,
            impl=impl))
        self.lr = lr
