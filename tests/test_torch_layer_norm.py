"""Port parity: LayerNorm/RMSNorm forward (kernel K1's plain path) and the
dispatch helpers, held against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import normalization as jnorm
from beforeholiday_tpu.ops._pallas_util import pad_rows as jax_pad_rows
from beforeholiday_tpu_torch.ops import normalization as tnorm
from beforeholiday_tpu_torch.ops._dispatch import pad_rows, resolve_impl

FNS = ("fused_layer_norm", "fused_rms_norm",
       "mixed_dtype_fused_layer_norm", "mixed_dtype_fused_rms_norm")


def _inputs(shape, x_dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    hidden = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(x_dtype)
    w = (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    b = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    return x, w, b


def _call(mod, fn, x, w, b, impl):
    has_bias = "rms" not in fn
    args = (x, w, b) if has_bias else (x, w)
    return getattr(mod, fn)(*args, eps=1e-5, impl=impl)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("shape", [(6, 32), (3, 5, 48), (4, 100)])
@pytest.mark.parametrize("jax_impl", ["pallas", "jnp"])
def test_norm_forward_matches_jax_fp32(fn, shape, jax_impl):
    x, w, b = _inputs(shape)
    ref = np.asarray(_call(jnorm, fn, jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(b), jax_impl))
    got = _call(tnorm, fn, torch.from_numpy(x), torch.from_numpy(w),
                torch.from_numpy(b), None)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fn", FNS)
def test_norm_output_dtype_follows_contract(fn):
    """fp16 activations with fp32 params: plain variants keep fp16, the
    mixed-dtype variants return the parameter dtype — same as JAX."""
    x, w, b = _inputs((4, 64), x_dtype=np.float16)
    ref = np.asarray(_call(jnorm, fn, jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(b), "jnp"))
    got = _call(tnorm, fn, torch.from_numpy(x), torch.from_numpy(w),
                torch.from_numpy(b), None)
    assert str(got.dtype).split(".")[-1] == ref.dtype.name
    tol = 1e-5 if "mixed" in fn else 2e-3  # fp16 output: one half-ulp
    np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32),
                               atol=tol, rtol=0)


def test_norm_backward_raises():
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 16)))
    x.requires_grad_(True)
    y = tnorm.fused_layer_norm(x, w, b)
    with pytest.raises(NotImplementedError):
        y.sum().backward()


def test_norm_checks_param_shapes():
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 16)))
    with pytest.raises(ValueError):
        tnorm.fused_layer_norm(x, w[:8], b)
    with pytest.raises(ValueError):
        tnorm.fused_layer_norm(x, w, b[:8])


@pytest.mark.parametrize("impl, want", [(None, "torch"), ("torch", "torch")])
def test_resolve_impl_cpu(impl, want):
    assert resolve_impl(impl, torch.zeros(2)) == want


@pytest.mark.parametrize("impl", ["kernel", "pallas", "jnp"])
def test_resolve_impl_rejects_impossible(impl):
    with pytest.raises(ValueError):
        resolve_impl(impl, torch.zeros(2))


def test_kernel_wrapper_refuses_cpu_tensors():
    """K1's wrapper launches on CUDA tensors or raises; it never falls back."""
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 16)))
    with pytest.raises(ValueError):
        tnorm.ln_fwd_kernel(x, w, b, 1e-5, False, torch.float32)
    with pytest.raises(ValueError):
        tnorm.fused_layer_norm(x, w, b, impl="kernel")


@pytest.mark.parametrize("shape, block", [((5, 3), 4), ((8, 2, 3), 4), ((7,), 7),
                                          ((1, 4), 8)])
def test_pad_rows_matches_jax(shape, block):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    ref, ref_rows = jax_pad_rows(jnp.asarray(x), block)
    got, rows = pad_rows(torch.from_numpy(x), block)
    assert rows == ref_rows
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
