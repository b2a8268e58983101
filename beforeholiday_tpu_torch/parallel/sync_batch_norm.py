"""(Sync)BatchNorm — counterpart of
``beforeholiday_tpu/parallel/sync_batch_norm.py``.

The JAX function is plain jnp (no Pallas kernel), and so is this one: the
same statistics in fp32 whatever the activations' dtype, the same two
``stats`` modes, the unbiased running variance, ``fuse_relu``, ``residual``
and the diagnostics flag. ``F.batch_norm`` is not used: it takes its
moments another way (Welford), and the default mode on one device takes
them around the running mean in one pass, as the JAX package does.

Training mode runs through :class:`_BatchNormTrain`, whose backward is the
BatchNorm gradient derived by hand (``dx = scale * inv * (g - mean(g) -
xhat * mean(g * xhat))``), written in torch ops. Autograd through the
forward's formula would save several fp32 copies of every activation (the
centred input, its square, the scaled output); the function saves only the
input and the output in their own dtype and the per-channel vectors, and
recomputes ``xhat`` in the backward. In exact arithmetic it is the gradient
JAX's autodiff takes of the same forward (the shift is a constant there).

With ``axis_name`` (the reference's SyncBN) the batch statistics are merged
across the group it names (``parallel_state.get_group``; NCCL on the card,
gloo on the CPU) in the two-pass form: one all-reduce of the per-channel
sums with the element count, the global mean, then one all-reduce of the
centred squares (site ``sync_bn.stats``). The backward all-reduces the
reference's pair (sum_dy, sum_dy_xmu) in one collective (site
``sync_bn.backward``) for the input's gradient; the scale and bias
gradients stay local, for DDP to reduce, as autodiff leaves them in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.ops._dispatch import resolve_device

# the envelope of one_pass_shifted: the batch mean may sit this many sigma
# from the running-mean shift before the E[d^2] - E[d]^2 combine is at risk
_SHIFT_SIGMAS = 30.0


class BatchNormParams(NamedTuple):
    scale: torch.Tensor  # (C,)
    bias: torch.Tensor  # (C,)


class BatchNormState(NamedTuple):
    running_mean: torch.Tensor  # (C,) fp32
    running_var: torch.Tensor  # (C,) fp32


def init_batch_norm(num_features: int, device=None
                    ) -> Tuple[BatchNormParams, BatchNormState]:
    """torch's BatchNorm init: scale 1, bias 0, mean 0, var 1 (fp32), on
    ``device`` (``cuda`` unless the caller asks for another one)."""
    device = resolve_device(device)
    ones = lambda: torch.ones(num_features, device=device)  # noqa: E731
    zeros = lambda: torch.zeros(num_features, device=device)  # noqa: E731
    return BatchNormParams(ones(), zeros()), BatchNormState(zeros(), ones())


def _affine(xf, mean, inv, scale, bias, residual, fuse_relu, shape_bc):
    """``((x - mean) * inv) * scale + bias (+ residual)``, then the ReLU, in
    fp32, in the JAX function's order."""
    y = (xf - mean.reshape(shape_bc)) * inv.reshape(shape_bc)
    y = y * scale.float().reshape(shape_bc) + bias.float().reshape(shape_bc)
    if residual is not None:
        y = y + residual.float()
    return torch.relu(y) if fuse_relu else y


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm: batch moments, the normalised output in
    ``x``'s dtype, and the moments (not differentiated) for the running
    statistics."""

    @staticmethod
    def forward(ctx, x, scale, bias, shift, residual, c_axis, eps, fuse_relu,
                two_pass, sync):
        reduce_axes = tuple(i for i in range(x.ndim) if i != c_axis)
        shape_bc = [1] * x.ndim
        shape_bc[c_axis] = x.shape[c_axis]
        count = math.prod(x.shape[i] for i in reduce_axes)
        xf = x.float()
        n = count
        if two_pass:
            # global mean first, then the centred second moment; across the
            # group, the per-channel sums and the element count in one
            # all-reduce, then the centred squares in another
            sums = xf.sum(reduce_axes)
            if sync is not None:
                both = comms.psum(torch.cat([sums, sums.new_full((1,), count)]),
                                  sync[0], site="sync_bn.stats",
                                  axis_index_groups=sync[1], inplace=True)
                sums, n = both[:-1], both[-1]
            mean = sums / n
            sq = torch.square(xf - mean.reshape(shape_bc)).sum(reduce_axes)
            if sync is not None:
                sq = comms.psum(sq, sync[0], site="sync_bn.stats",
                                axis_index_groups=sync[1], inplace=True)
            var = sq / n
            shift_dominated = torch.zeros((), dtype=torch.int32, device=x.device)
        else:
            # one read: both moments around the running mean (a constant)
            d = xf - shift.float().reshape(shape_bc)
            dmean = d.sum(reduce_axes) / count
            s2 = (d * d).sum(reduce_axes)
            del d
            mean = shift.float() + dmean
            var = torch.clamp(s2 / count - dmean * dmean, min=0.0)
            shift_dominated = torch.any(
                dmean * dmean > _SHIFT_SIGMAS ** 2 * (var + eps)).to(torch.int32)
        inv = torch.rsqrt(var + eps)
        out = _affine(xf, mean, inv, scale, bias, residual, fuse_relu,
                      shape_bc).to(x.dtype)
        # the running variance is the unbiased one (torch semantics), from
        # the global count
        if sync is None:
            unbiased = var * count / max(count - 1.0, 1.0)
        else:
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        ctx.save_for_backward(x, scale, mean, inv, out if fuse_relu else None,
                              n if sync is not None else None)
        ctx.meta = (reduce_axes, shape_bc, count, fuse_relu,
                    None if residual is None else residual.dtype, bias.dtype, sync)
        ctx.mark_non_differentiable(mean, unbiased, shift_dominated)
        return out, mean, unbiased, shift_dominated

    @staticmethod
    def backward(ctx, dy, _dmean, _dunbiased, _dflag):
        x, scale, mean, inv, out, count_t = ctx.saved_tensors
        (reduce_axes, shape_bc, count, fuse_relu, res_dtype, bias_dtype,
         sync) = ctx.meta
        g = dy.float()
        if fuse_relu:
            # relu(y) > 0 exactly where y > 0 (a positive fp32 stays positive
            # in bf16, which shares its exponent range)
            g = torch.where(out > 0, g, 0.0)
        xhat = (x.float() - mean.reshape(shape_bc)) * inv.reshape(shape_bc)
        dbias = g.sum(reduce_axes)
        dscale = (g * xhat).sum(reduce_axes)
        sum_dy, sum_dy_xmu, n = dbias, dscale, count
        if sync is not None:
            # the reference's (sum_dy, sum_dy_xmu) pair over the group, in
            # one collective; the parameter gradients stay local
            axis_name, groups = sync
            both = comms.psum(torch.stack([dbias, dscale]), axis_name,
                              site="sync_bn.backward", axis_index_groups=groups)
            sum_dy, sum_dy_xmu, n = both[0], both[1], count_t
        coef = scale.float() * inv
        dx = (g - (sum_dy / n).reshape(shape_bc)
              - xhat * (sum_dy_xmu / n).reshape(shape_bc)) * coef.reshape(shape_bc)
        dres = None if res_dtype is None else g.to(res_dtype)
        return (dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(bias_dtype),
                None, dres, None, None, None, None, None)


def sync_batch_norm(
    x: torch.Tensor,
    params: BatchNormParams,
    state: BatchNormState,
    *,
    training: bool = True,
    momentum: float = 0.1,
    eps: float = 1e-5,
    axis_name: Optional[str] = None,
    axis_index_groups=None,
    channel_last: bool = False,
    fuse_relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    stats: str = "auto",
    return_diagnostics: bool = False,
):
    """Apply BatchNorm. Returns ``(y, new_state)``, or ``(y, new_state,
    diagnostics)`` with ``return_diagnostics=True``.

    ``x``: (N, C, *spatial), or (N, *spatial, C) with ``channel_last``. (The
    port's ResNet keeps its activations as logical NCHW tensors in
    ``torch.channels_last`` memory, so it passes ``channel_last=False``.)
    ``y`` has ``x``'s dtype; the statistics and the running state are fp32.
    ``residual`` is added before the ReLU of ``fuse_relu``.

    ``stats``: ``"one_pass_shifted"`` (what ``"auto"`` means without
    ``axis_name``) takes both moments around the running mean in one read;
    ``"two_pass"`` (what it means with one) takes the global mean first,
    then the centred second moment. The JAX docstring states the accuracy
    envelope of the first. ``diagnostics["bn_shift_dominated"]`` is a
    device int32, 1 when a channel left that envelope (always 0 for
    two_pass and eval).

    ``axis_name`` (an axis name or a ``ProcessGroup``) merges the training
    statistics across that group (the module docstring);
    ``axis_index_groups`` restricts the merge to subgroups of it."""
    if stats == "auto":
        stats = "two_pass" if axis_name is not None else "one_pass_shifted"
    if stats not in ("two_pass", "one_pass_shifted"):
        raise ValueError(f"stats must be auto|two_pass|one_pass_shifted, got {stats!r}")
    if stats == "one_pass_shifted" and axis_name is not None:
        raise ValueError(
            "one_pass_shifted is single-device only; the cross-device merge "
            "uses the two-pass form")
    c_axis = x.ndim - 1 if channel_last else 1
    if training:
        sync = None if axis_name is None else (axis_name, axis_index_groups)
        y, mean, unbiased, flag = _BatchNormTrain.apply(
            x, params.scale, params.bias, state.running_mean, residual, c_axis,
            eps, fuse_relu, stats == "two_pass", sync)
        new_state = BatchNormState(
            (1.0 - momentum) * state.running_mean + momentum * mean,
            (1.0 - momentum) * state.running_var + momentum * unbiased,
        )
    else:
        shape_bc = [1] * x.ndim
        shape_bc[c_axis] = x.shape[c_axis]
        inv = torch.rsqrt(state.running_var + eps)
        y = _affine(x.float(), state.running_mean, inv, params.scale,
                    params.bias, residual, fuse_relu, shape_bc).to(x.dtype)
        new_state = state
        flag = torch.zeros((), dtype=torch.int32, device=x.device)
    if return_diagnostics:
        return y, new_state, {"bn_shift_dominated": flag}
    return y, new_state
