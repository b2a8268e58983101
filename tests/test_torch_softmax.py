"""Port parity: the scaled / masked / causal softmax family
(``beforeholiday_tpu_torch/ops/softmax.py``, kernels K11/K12 on the card)
and ``transformer.functional.FusedScaleMaskSoftmax``, held against the JAX
package on the same numpy inputs, forward and backward (``jax.vjp`` against
torch autograd), in fp32 and bf16.

The JAX side runs its Pallas kernels in interpret mode (``impl="pallas"``)
and its jnp path (``impl="jnp"``); the port runs the kernels' plain versions
(CPU tensors). Tolerances, and why, are in PERF.md.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import softmax as jsm
from beforeholiday_tpu.transformer import AttnMaskType as JMaskType
from beforeholiday_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JFused,
)
from beforeholiday_tpu_torch.ops import softmax as tsm
from beforeholiday_tpu_torch.transformer import AttnMaskType as TMaskType
from beforeholiday_tpu_torch.transformer.functional import (
    FusedScaleMaskSoftmax as TFused,
)


@pytest.fixture(autouse=True, scope="module")
def _mkl_threads_started():
    """Make this process's first multi-threaded ``torch.exp`` before the
    cases run. This CPU build sends ``torch.exp`` to MKL's vector math
    library on up to one OpenMP thread per 2048 elements, and that first
    call of a fresh process under load has come back from some of the new
    threads with an exp good to 1.8e-4 instead of 6e-8 (the last two
    quarters of the first case's rows), while every later call was exact.
    A worker of the parallel test run whose first test is this file's first
    case then failed it (ROADMAP queue C, C3)."""
    torch.exp(torch.zeros(1 << 16))


DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
JAX_IMPLS = ("pallas", "jnp")
SCALE = 0.37


def _tol(name, ref):
    """fp32: exp and the row sums in another order; bf16: both packages
    compute in fp32 and round once, so one bf16 ulp where the fp32 values
    straddle a rounding boundary."""
    amax = float(np.abs(ref).max()) or 1.0
    if name == "fp32":
        return dict(rtol=1e-5, atol=1e-6 * amax)
    return dict(rtol=2.0 ** -7, atol=2.0 ** -9 * amax)


def _np(t):
    return t.detach().float().numpy()


def _mask(rng, shape, full_row=True):
    """A random boolean mask; its second row fully masked."""
    m = rng.random(shape) > 0.7
    if full_row:
        m.reshape(-1, shape[-1])[1] = True
    return m


# (x shape, mask shape or None, variant); the scores are scaled by 3 so the
# softmax is not nearly uniform
CASES = {
    "scaled": ((2, 3, 16, 77), None, "scaled"),
    "masked_b1sqsk": ((2, 3, 16, 77), (2, 1, 16, 77), "masked"),
    "masked_b11sk": ((2, 3, 16, 128), (2, 1, 1, 128), "masked"),
    "generic_2d": ((5, 48), (5, 48), "generic"),
    "generic_4d": ((2, 2, 8, 33), (2, 1, 8, 33), "generic"),
    "causal_sq128": ((4, 128, 128), None, "causal"),
    "causal_sq96": ((2, 96, 96), None, "causal"),
}


def _fns(variant, mask, jax_impl):
    if variant == "scaled":
        return (lambda a: jsm.scaled_softmax(a, SCALE, impl=jax_impl),
                lambda a: tsm.scaled_softmax(a, SCALE))
    if variant == "causal":
        return (lambda a: jsm.scaled_upper_triang_masked_softmax(a, SCALE, impl=jax_impl),
                lambda a: tsm.scaled_upper_triang_masked_softmax(a, SCALE))
    jfn, tfn = ((jsm.scaled_masked_softmax, tsm.scaled_masked_softmax)
                if variant == "masked" else
                (jsm.generic_scaled_masked_softmax, tsm.generic_scaled_masked_softmax))
    jm, tm = jnp.array(mask), torch.tensor(mask)
    return (lambda a: jfn(a, jm, SCALE, impl=jax_impl),
            lambda a: tfn(a, tm, SCALE))


def _vjp_pair(jfn, tfn, x, dy, dtype):
    """Forward and the VJP with cotangent ``dy`` in both packages, each on
    its own copy of the inputs (``jnp.asarray`` and ``torch.from_numpy`` may
    both alias the numpy buffer)."""
    jdt, tdt = DTYPES[dtype]
    jy, vjp = jax.vjp(jfn, jnp.array(x, jdt))
    (jdx,) = vjp(jnp.array(dy, jdt))
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    ty = tfn(tx)
    ty.backward(torch.tensor(dy).to(tdt))
    return (np.asarray(jy, np.float32), np.asarray(jdx, np.float32)), (ty, tx.grad)


def _y_float64(variant, x, mask):
    """The forward in float64 from the same fp32 scores (``x * scale``
    rounded to fp32, as both packages compute them), -10000 where masked:
    the oracle that says which package drifted if the two part."""
    s = (x * np.float32(SCALE)).astype(np.float64)
    if variant == "causal":
        sq, sk = s.shape[-2:]
        s = np.where(np.arange(sk)[None, :] > np.arange(sq)[:, None], -10000.0, s)
    if mask is not None:
        s = np.where(np.broadcast_to(mask, s.shape), -10000.0, s)
    e = np.exp(s - s.max(-1, keepdims=True))
    y = e / e.sum(-1, keepdims=True)
    if variant == "generic":
        y = np.where(np.all(mask, axis=-1, keepdims=True), 0.0, y)
    return y


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_public_functions_match_jax(case, jax_impl, dtype):
    shape, mshape, variant = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    mask = None if mshape is None else _mask(rng, mshape)
    jfn, tfn = _fns(variant, mask, jax_impl)
    (jy, jdx), (ty, tdx) = _vjp_pair(jfn, tfn, x, dy, dtype)
    tdt = DTYPES[dtype][1]
    assert ty.dtype == tdx.dtype == tdt and ty.shape == tdx.shape == shape
    if dtype == "fp32":
        y64 = _y_float64(variant, x, mask)
        np.testing.assert_allclose(jy, y64, **_tol(dtype, y64),
                                   err_msg="JAX vs float64")
        np.testing.assert_allclose(_np(ty), y64, **_tol(dtype, y64),
                                   err_msg="port vs float64")
    np.testing.assert_allclose(_np(ty), jy, **_tol(dtype, jy))
    np.testing.assert_allclose(_np(tdx), jdx, **_tol(dtype, jdx))


def test_fully_masked_rows():
    """-10000, not -inf: a fully masked row is uniform 1/sk from
    ``scaled_masked_softmax`` and all zeros (gradient too) from the generic
    variant; a partly masked row puts no weight on its masked keys."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 2, 4, 77)).astype(np.float32))
    mask = torch.zeros(2, 1, 4, 77, dtype=torch.bool)
    mask[0, 0, 1] = True
    mask[1, 0, 2, 40:] = True
    y = tsm.scaled_masked_softmax(x, mask, 2.0)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y[0, :, 1], torch.full((2, 77), 1 / 77))
    assert torch.all(y[1, :, 2, 40:] == 0)
    xg = x.clone().requires_grad_(True)
    yg = tsm.generic_scaled_masked_softmax(xg, mask, 2.0)
    assert torch.all(yg[0, :, 1] == 0)
    torch.testing.assert_close(yg[1], y[1])
    yg.sum().backward()
    assert torch.all(xg.grad[0, :, 1] == 0)


@pytest.mark.parametrize("mask_dtype", [torch.int8, torch.int32, torch.float32])
def test_mask_dtypes_mean_nonzero(mask_dtype):
    """Any nonzero mask value masks, as JAX's ``mask != 0``."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 9)).astype(np.float32))
    m = torch.from_numpy(_mask(rng, (2, 1, 5, 9)))
    ref = tsm.scaled_masked_softmax(x, m, 0.5)
    got = tsm.scaled_masked_softmax(x, (m.to(mask_dtype) * 3), 0.5)
    assert torch.equal(got, ref)


def test_cpu_tensors_run_the_plain_version():
    """A CPU tensor runs the plain version and launches nothing; asking for
    the kernel there raises."""
    x = torch.randn(2, 4, 8, 8)
    before = (tsm.softmax_fwd_kernel.launches, tsm.softmax_bwd_kernel.launches)
    tsm.scaled_softmax(x.requires_grad_(True), 2.0).sum().backward()
    assert (tsm.softmax_fwd_kernel.launches,
            tsm.softmax_bwd_kernel.launches) == before
    with pytest.raises(ValueError):
        tsm.scaled_softmax(x, 2.0, impl="kernel")
    with pytest.raises(ValueError):
        tsm.scaled_upper_triang_masked_softmax(torch.randn(2, 8, 6))


def test_masked_variant_saves_fp32_probabilities():
    """The masked variant's backward reads the unrounded fp32 y (JAX's
    kernel runs on fp32 filled scores); the plain forward returns it."""
    x = torch.randn(1, 2, 3, 10).to(torch.bfloat16)
    mask = (torch.rand(1, 1, 3, 10) > 0.5).expand(x.shape)
    y, y32 = tsm.softmax_fwd_torch(x, 0.5, False, mask)
    assert y.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    y, y32 = tsm.softmax_fwd_torch(x.float(), 0.5, False, mask)
    assert y32 is y
    # without a mask the backward reads y itself: no fp32 copy
    assert tsm.softmax_fwd_torch(x, 0.5, True)[1] is None


# ------------------------------------------------- FusedScaleMaskSoftmax


# name -> (constructor kwargs (JAX names), x shape, mask shape or None)
FUSED = {
    "bf16_padding_mask": (dict(input_in_bf16=True, scale=0.5), (2, 3, 16, 77), (2, 1, 16, 77)),
    "bf16_padding_keys": (dict(input_in_bf16=True, scale=0.5), (2, 3, 16, 64), (2, 1, 1, 64)),
    "bf16_no_mask": (dict(input_in_bf16=True, scale=0.25), (2, 3, 16, 40), None),
    "fp16_causal": (dict(input_in_fp16=True, attn_mask_type="causal", scale=0.125),
                    (1, 2, 128, 128), None),
    "bf16_causal_sq96_eager": (dict(input_in_bf16=True, attn_mask_type="causal",
                                    scale=0.125), (1, 2, 96, 96), None),
    "fp32_eager": (dict(scale=0.5), (2, 3, 16, 77), (2, 1, 16, 77)),
    "bf16_no_fusion": (dict(input_in_bf16=True, scaled_masked_softmax_fusion=False,
                            scale=0.5), (2, 3, 16, 77), (2, 1, 16, 77)),
    "bf16_mask_func": (dict(input_in_bf16=True, scaled_masked_softmax_fusion=False,
                            mask_func="subtract"), (2, 3, 16, 24), (2, 1, 16, 24)),
    "bf16_softmax_in_bf16": (dict(input_in_bf16=True, softmax_in_fp32=False,
                                  scaled_masked_softmax_fusion=False),
                             (2, 3, 8, 24), (2, 1, 8, 24)),
}


def _modules(kw):
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("attn_mask_type") == "causal":
        jkw["attn_mask_type"], tkw["attn_mask_type"] = JMaskType.causal, TMaskType.causal
    if kw.get("mask_func") == "subtract":
        # works on jnp and torch operands alike
        jkw["mask_func"] = tkw["mask_func"] = lambda s, m: s - 20000.0 * m
    return JFused(**jkw), TFused(**tkw)


@pytest.fixture(params=JAX_IMPLS)
def jax_impl(request, monkeypatch):
    """The JAX module's kernel branch dispatches with impl=None, which is
    jnp on the CPU: patch its resolution to run the Pallas kernels too."""
    if request.param == "pallas":
        resolve = jsm._resolve_impl
        monkeypatch.setattr(jsm, "_resolve_impl",
                            lambda impl: resolve("pallas" if impl is None else impl))
    return request.param


@pytest.mark.parametrize("name", FUSED)
def test_fused_scale_mask_softmax_matches_jax(name, jax_impl):
    kw, shape, mshape = FUSED[name]
    jmod, tmod = _modules(kw)
    dtype = ("fp16" if kw.get("input_in_fp16") else
             "bf16" if kw.get("input_in_bf16") else "fp32")
    jdt, tdt = {"fp16": (jnp.float16, torch.float16), **DTYPES}[dtype]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    mask = None if mshape is None else _mask(rng, mshape)
    b, np_, sq, sk = shape
    assert tmod.is_kernel_available(mask, b, np_, sq, sk) == \
        jmod.is_kernel_available(mask, b, np_, sq, sk)
    jm = None if mask is None else jnp.array(mask)
    tm = None if mask is None else torch.tensor(mask)
    jy, vjp = jax.vjp(lambda a: jmod(a, jm), jnp.array(x, jdt))
    (jdx,) = vjp(jnp.array(dy, jy.dtype))
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    ty = tmod(tx, tm)
    assert str(ty.dtype).replace("torch.", "") == jnp.dtype(jy.dtype).name
    ty.backward(torch.tensor(dy).to(ty.dtype))
    jy, jdx = np.asarray(jy, np.float32), np.asarray(jdx, np.float32)
    # fp16 inputs take the bf16 bound (fp16 holds 3 more mantissa bits)
    kind = "fp32" if dtype == "fp32" else "bf16"
    tol_y, tol_dx = _tol(kind, jy), _tol(kind, jdx)
    if not kw.get("softmax_in_fp32", True):
        # the softmax itself in bf16: each package rounds its intermediates
        # at other places, a few ulp
        tol_y = tol_dx = dict(rtol=4 * 2.0 ** -7, atol=4 * 2.0 ** -8)
    np.testing.assert_allclose(_np(ty), jy, **tol_y)
    np.testing.assert_allclose(_np(tx.grad), jdx, **tol_dx)


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("mask_type", ["padding", "causal"])
@pytest.mark.parametrize("flags", ["fp16", "bf16", "fp32"])
def test_is_kernel_available_matches_jax(flags, mask_type, fusion):
    kw = dict(input_in_fp16=flags == "fp16", input_in_bf16=flags == "bf16",
              scaled_masked_softmax_fusion=fusion)
    jmod = JFused(attn_mask_type=getattr(JMaskType, mask_type), **kw)
    tmod = TFused(attn_mask_type=getattr(TMaskType, mask_type), **kw)
    sizes = (0, 1, 16, 96, 128, 256, 1000, 1024, 16384, 16385)
    for sq, sk in itertools.product(sizes, sizes):
        assert tmod.is_kernel_available(None, 2, 4, sq, sk) == \
            jmod.is_kernel_available(None, 2, 4, sq, sk), (sq, sk)


def test_fused_module_refuses_what_jax_refuses():
    with pytest.raises(RuntimeError):
        TFused(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError):
        TFused(softmax_in_fp32=False, scale=2.0)
    causal = TFused(input_in_bf16=True, attn_mask_type=TMaskType.causal)
    x = torch.randn(1, 2, 128, 128).to(torch.bfloat16)
    with pytest.raises(ValueError):
        causal(x, torch.zeros(1, 1, 128, 128, dtype=torch.bool))
    with pytest.raises(ValueError):
        causal(x[0])
