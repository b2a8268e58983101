"""fp8 quantized matmul, the arithmetic of amp O6 — counterpart of
``beforeholiday_tpu/ops/quantized.py``.

FP8 training after Micikevicius et al. 2022: the forward operands quantize
to ``e4m3`` (max 448, finite only), the backward's cotangent to ``e5m2``
(max 57344, with infinities), each under one fp32 scale per tensor, and the
products accumulate in fp32.

Scales, as in the JAX package:

* the activation ``x`` takes a just-in-time scale from its own amax;
* the weight and the cotangent take the delayed scales of the active
  :func:`quantized_scope` (``amp.scaled_value_and_grad`` and ``StepGuard``
  derive them from the amax history in the loss scaler's state); outside a
  scope, or under the 0.0 sentinel, they are just in time too.

The weight's cast saturates at ±448, so a stale scale costs accuracy, never
a NaN. The cotangent's cast does not: an e5m2 overflow is ±inf, which the
unscale kernel (K5) flags, and the step is skipped and the loss scale
halved as for any overflow.

The JAX package computes the three products with an XLA ``dot_general`` on
fp8 operands, outside any Pallas kernel, so on the card they are library
GEMMs: ``torch._scaled_mm`` (cuBLASLt on Hopper's fp8 tensor cores), with
fp32 output and fp32 accumulation (``use_fast_accum=False``). cuBLASLt takes
the first operand row-major and the second column-major, every dimension a
multiple of 16: each operand is quantized in its natural layout and the fp8
tensor is transposed (one byte an element) where a product reads the other
orientation; a ragged dimension is padded with zeros, which is exact. The
fp32 reciprocal of the two scales' product is the GEMM's one output scale,
so the result is rounded as JAX's ``dot * (1 / (sx * sw))``. On a CPU
tensor, or with ``impl="torch"``, the same fp8 values are widened to fp32
and multiplied by ``torch.matmul`` (the JAX package's upcast oracle). The
two agree to fp32 summation order, not bit for bit.

The quantize passes are plain PyTorch (widen, scale, clamp, cast), as the
JAX package's are XLA elementwise ops. The backward runs on autograd's
thread, where the thread-local scope is not set: the forward saves the
weight's and the cotangent's scales in the autograd context, and the
backward never reads the scope.

:data:`product_counts` counts the products by path and pass.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.ops._dispatch import resolve_impl
from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten

__all__ = [
    "E4M3_MAX",
    "E4M3_REL",
    "E4M3_TINY",
    "E5M2_MAX",
    "HISTORY_ROLES",
    "amax_of_tree",
    "init_amax_history",
    "jit_scale_e4m3",
    "loss_parity_bound",
    "quantize_e4m3",
    "quantized_matmul",
    "quantized_matmul_error_bound",
    "quantized_scope",
    "scales_from_history",
    "update_amax_history",
]

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
# e4m3's round-to-nearest relative error (half an ulp at 3 mantissa bits)
# and its smallest positive subnormal, the absolute error floor: the error
# model of the bounds here and of the fp8 KV pages
E4M3_REL = 2.0 ** -4
E4M3_TINY = 2.0 ** -9

# the delayed-scaled roles, in the amax history's row order; activations
# are scaled just in time and keep no history
HISTORY_ROLES = ("weight", "grad")

_ALLOWED_DTYPES = (torch.float16, torch.bfloat16, torch.float32)
# cuBLASLt's fp8 GEMM takes dimensions in multiples of 16
_ALIGN = 16

# products by path ("fp8": torch._scaled_mm; "plain": the widened fp32
# product) and pass; a caller resets them by assigning 0
product_counts = {"fp8_forward": 0, "fp8_backward": 0,
                  "plain_forward": 0, "plain_backward": 0}


# ------------------------------------------------------------------ the scope
class _Scope(threading.local):
    scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


_SCOPE = _Scope()


def div(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` rounded once, as ``jnp`` divides: PyTorch's ``float /
    tensor`` multiplies by ``t``'s rounded reciprocal instead."""
    return torch.div(t.new_full((), c), t)


def _f32(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32)
    return torch.tensor(float(value), dtype=torch.float32)


@contextlib.contextmanager
def quantized_scope(scale_w, scale_g):
    """Provide this step's delayed scales (weight, grad) to every
    :func:`quantized_matmul` in the block, as fp32 0-d tensors (device
    tensors stay where they are: no host sync). Nests; per thread."""
    prev = _SCOPE.scales
    _SCOPE.scales = (_f32(scale_w), _f32(scale_g))
    try:
        yield
    finally:
        _SCOPE.scales = prev


def active_scales() -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The innermost scope's (scale_w, scale_g), or None outside a scope."""
    return _SCOPE.scales


# -------------------------------------------------------------- amax history
def init_amax_history(length: int = 16, device=None) -> torch.Tensor:
    """A fresh (len(HISTORY_ROLES), length) fp32 history of zeros, "no
    observation yet": :func:`scales_from_history` gives such a role scale
    1.0."""
    if length < 1:
        raise ValueError(f"amax history length must be >= 1, got {length}")
    return torch.zeros((len(HISTORY_ROLES), int(length)), dtype=torch.float32,
                       device=device)


def update_amax_history(hist: torch.Tensor, amax_w, amax_g) -> torch.Tensor:
    """Roll the newest (weight, grad) amax observations into slot 0.
    Non-finite observations become 0 (ignored): an overflow step's inf amax
    would otherwise poison the scale, and ``found_inf`` handles the event."""
    obs = torch.stack([torch.as_tensor(amax_w, dtype=torch.float32,
                                       device=hist.device).reshape(()),
                       torch.as_tensor(amax_g, dtype=torch.float32,
                                       device=hist.device).reshape(())])
    obs = torch.where(torch.isfinite(obs), obs, 0.0)
    return torch.cat([obs[:, None], hist[:, :-1]], dim=1)


def scales_from_history(hist: torch.Tensor, *, margin: float = 2.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale_w, scale_g) from the history's maxima: each maps the role's
    largest amax to ``fmt_max / margin`` (headroom for growth between steps,
    since delayed scales are one step stale). A role with an all-zero
    history gets 1.0."""
    if margin < 1.0:
        raise ValueError(f"margin must be >= 1.0, got {margin}")
    amax = hist.amax(dim=1)
    targets = (E4M3_MAX / margin, E5M2_MAX / margin)
    return tuple(torch.where(amax[i] > 0.0, div(targets[i], amax[i]), 1.0)
                 for i in range(len(HISTORY_ROLES)))


def _amax(t: torch.Tensor) -> torch.Tensor:
    """max|t| in fp32, one pass; exact in t's own type, so widening after
    is exact too. 0 for an empty tensor."""
    if t.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=t.device)
    return torch.linalg.vector_norm(t.detach(), float("inf")).float()


def amax_of_tree(tree) -> torch.Tensor:
    """max|.| over every floating tensor of a tree, or over a
    :class:`PackedParams`' arenas (whose zero padding changes nothing):
    the step-level observation for the delayed rows (params for ``weight``,
    the still-scaled grads for ``grad``). fp32 0.0 for a tree without
    floating tensors."""
    leaves = (list(tree.arenas) if isinstance(tree, PackedParams)
              else tree_flatten(tree)[0])
    amaxes = [_amax(t) for t in leaves
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not amaxes:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(amaxes).amax()


# --------------------------------------------------------------- quantization
def _jit_scale(amax: torch.Tensor, fmt_max: float) -> torch.Tensor:
    """The just-in-time scale of a tensor whose amax is ``amax``: amax ->
    fmt_max, 1.0 for a zero tensor."""
    return torch.where(amax > 0.0, div(fmt_max, amax), 1.0)


def _q_e4m3(a: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # SATURATING: the cast itself turns an out-of-range value into NaN
    # (e4m3fn has no inf), so clamp first; the product is fp32, as in JAX
    t = a.to(torch.float32) * scale
    return t.clamp_(-E4M3_MAX, E4M3_MAX).to(E4M3)


def _q_e5m2(a: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # NON-saturating: an overflow becomes ±inf, the found_inf signal
    return (a.to(torch.float32) * scale).to(E5M2)


def jit_scale_e4m3(a: torch.Tensor, *, margin: float = 1.0) -> torch.Tensor:
    """Public just-in-time e4m3 scale: amax -> ``E4M3_MAX / margin`` (1.0
    for an all-zero tensor). ``margin > 1`` leaves headroom for values
    written later under the same frozen scale (the fp8 KV pages)."""
    if margin < 1.0:
        raise ValueError(f"margin must be >= 1.0, got {margin}")
    return _jit_scale(_amax(a), E4M3_MAX / margin)


def quantize_e4m3(a: torch.Tensor, scale) -> torch.Tensor:
    """Public saturating e4m3 cast, ``clip(a * scale, ±E4M3_MAX)`` in e4m3."""
    return _q_e4m3(a, _f32(scale).to(a.device))


# ----------------------------------------------------------------- products
def _pad_to(q: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A contiguous copy of the fp8 matrix ``q`` zero-padded to (rows,
    cols), through its bytes (0x00 is +0 in both formats)."""
    if q.shape == (rows, cols):
        return q.contiguous()
    b = F.pad(q.view(torch.uint8), (0, cols - q.shape[1], 0, rows - q.shape[0]))
    return b.view(q.dtype)


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _fp8_mm(a: torch.Tensor, b: torch.Tensor, inv: torch.Tensor,
            which: str) -> torch.Tensor:
    """``(a @ b) * inv`` on the card's fp8 tensor cores: a (m, k) and b
    (k, n) fp8 matrices, inv an fp32 0-d tensor, fp32 out. ``a`` is used
    row-major and ``b`` column-major (through its contiguous transpose),
    each padded to multiples of 16."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _up(m), _up(k), _up(n)
    a2 = _pad_to(a, mp, kp)
    bt = _pad_to(b.t(), np_, kp)  # (n, k) row-major: b column-major
    one = torch.ones((), dtype=torch.float32, device=a.device)
    y = torch._scaled_mm(a2, bt.t(), scale_a=inv.reshape(()).contiguous(),
                         scale_b=one, out_dtype=torch.float32,
                         use_fast_accum=False)
    product_counts[f"fp8_{which}"] += 1
    return y[:m, :n]


def _plain_mm(a: torch.Tensor, b: torch.Tensor, inv: torch.Tensor,
              which: str) -> torch.Tensor:
    """The plain version of :func:`_fp8_mm`: the same fp8 values widened to
    fp32 (exact) and multiplied in fp32, then scaled."""
    y = torch.matmul(a.to(torch.float32), b.to(torch.float32)) * inv
    product_counts[f"plain_{which}"] += 1
    return y


class _QuantizedMatmul(torch.autograd.Function):
    """``x2 @ w`` for a 2-D x, with fp8 operands and an fp32 result; the
    gradients come back in the primal dtypes."""

    @staticmethod
    def forward(ctx, x2, w, sw, sg, impl):
        mm = _fp8_mm if impl == "kernel" else _plain_mm
        sx = _jit_scale(_amax(x2), E4M3_MAX)
        # the 0.0 sentinel: no delayed scale in scope, just in time from w
        sw_eff = torch.where(sw > 0.0, sw, _jit_scale(_amax(w), E4M3_MAX))
        qx = _q_e4m3(x2, sx)
        qw = _q_e4m3(w, sw_eff)
        y = mm(qx, qw, div(1.0, sx * sw_eff), "forward")
        ctx.save_for_backward(qx, qw, sx, sw_eff, sg)
        ctx.mm = mm
        ctx.dtypes = (x2.dtype, w.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        qx, qw, sx, sw, sg = ctx.saved_tensors
        mm = ctx.mm
        sg_eff = torch.where(sg > 0.0, sg, _jit_scale(_amax(dy), E5M2_MAX))
        q_dy = _q_e5m2(dy, sg_eff)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx = dy @ w^T
            dx = mm(q_dy, qw.t(), div(1.0, sg_eff * sw), "backward")
            dx = dx.to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            # dw = x^T @ dy, over every leading (batch, sequence) row
            dw = mm(qx.t(), q_dy, div(1.0, sx * sg_eff), "backward")
            dw = dw.to(ctx.dtypes[1])
        return dx, dw, None, None, None


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, *,
                     impl: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` with fp8 operands and fp32 accumulation, the O6 GEMM. x:
    (..., K); w: (K, N); returns fp32 (callers cast back, as
    ``ops.dense`` does).

    The forward quantizes both operands to e4m3 (x just in time, w under
    the scope's delayed scale); the backward quantizes the cotangent to
    e5m2 and computes both gradients from the saved fp8 operands, which
    are all the activation memory it keeps. The gradients come back in the
    primal dtypes.

    ``impl``: None picks the card's fp8 GEMM for a CUDA tensor and the
    plain version for a CPU one; ``"kernel"`` or ``"torch"`` force one
    (``"kernel"`` on a CPU tensor raises)."""
    for name, a in (("x", x), ("w", w)):
        if not isinstance(a, torch.Tensor) or a.dtype not in _ALLOWED_DTYPES:
            raise TypeError(
                f"quantized_matmul: {name} has unsupported dtype "
                f"{getattr(a, 'dtype', None)}; O6 quantizes float16/bfloat16/"
                f"float32 operands only")
    if w.ndim != 2 or x.ndim < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"quantized_matmul expects x (..., K) and w (K, N); "
                         f"got {tuple(x.shape)} @ {tuple(w.shape)}")
    impl = resolve_impl(impl, x, op="quantized_matmul")
    scales = active_scales()
    if scales is None:
        sw = sg = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        sw, sg = (s.to(x.device) for s in scales)
    y = _QuantizedMatmul.apply(x.reshape(-1, x.shape[-1]), w, sw, sg, impl)
    return y.reshape(*x.shape[:-1], w.shape[1])


# ------------------------------------------------------------- error bounds
def quantized_matmul_error_bound(x: torch.Tensor, w: torch.Tensor, *,
                                 scale_w=None) -> torch.Tensor:
    """The largest elementwise error of ``quantized_matmul(x, w)`` against
    the fp32 ``x @ w``, by the JAX package's derivation: each dequantized
    operand errs by ``REL·|a| + TINY/s`` (plus the clip excess of a stale
    weight scale), a product term by ``ax·ew + aw·ex + ex·ew``, K terms add
    up, and fp32 accumulation adds ``2·K²·2⁻²⁴·(ax+ex)(aw+ew)``. The scale
    selection mirrors the op's: x just in time, w from ``scale_w`` or the
    active scope, else just in time."""
    x32, w32 = x.to(torch.float32), w.to(torch.float32)
    ax, aw = _amax(x32), _amax(w32)
    sx = _jit_scale(ax, E4M3_MAX)
    if scale_w is None:
        scales = active_scales()
        scale_w = scales[0] if scales is not None else None
    jit_w = _jit_scale(aw, E4M3_MAX)
    sw = jit_w if scale_w is None else _f32(scale_w).to(w32.device)
    sw = torch.where(sw > 0.0, sw, jit_w)
    clip_w = torch.clamp(aw - div(E4M3_MAX, sw), min=0.0)
    ex = E4M3_REL * ax + div(E4M3_TINY, sx)
    ew = E4M3_REL * aw + div(E4M3_TINY, sw) + clip_w
    k = float(x.shape[-1])
    quant = k * (ax * ew + aw * ex + ex * ew)
    accum = 2.0 * k * k * 2.0 ** -24 * (ax + ex) * (aw + ew)
    return quant + accum


def loss_parity_bound(step, *, n_matmuls: int, loss_ceiling: float,
                      growth: float = 1.2) -> float:
    """The envelope of ``|loss_O6(t) - loss_O5(t)|`` over a training run:
    ``loss_ceiling · ((1 + 2·E4M3_REL)**n_matmuls - 1) · growth**step``,
    the compounded worst-case relative perturbation of ``n_matmuls``
    quantized GEMMs in sequence, turned into a loss difference by the
    ceiling (softmax cross entropy is 1-Lipschitz in the logits per token)
    and grown each step by ``growth``. Worst case over everything, hence
    loose."""
    if n_matmuls < 1:
        raise ValueError(f"n_matmuls must be >= 1, got {n_matmuls}")
    eps_fwd = (1.0 + 2.0 * E4M3_REL) ** n_matmuls - 1.0
    return float(loss_ceiling) * eps_fwd * float(growth) ** float(step)

