"""Port parity: LayerNorm/RMSNorm forward and backward (kernels K1/K3's
plain paths) and the dispatch helpers, held against the JAX package on the
same numpy inputs."""

import jax
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


def _grads_jax(fn, x, w, b, dy, impl):
    has_bias = "rms" not in fn

    def f(x, w, b):
        args = (x, w, b) if has_bias else (x, w)
        y = getattr(jnorm, fn)(*args, eps=1e-5, impl=impl)
        return jnp.sum(y.astype(jnp.float32) * dy)

    g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b))
    return [np.asarray(a) for a in (g if has_bias else g[:2])]


def _grads_torch(fn, x, w, b, dy):
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = _call(tnorm, fn, xt, wt, bt, None)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    return [t.grad for t in ((xt, wt, bt) if "rms" not in fn else (xt, wt))]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("shape", [(6, 32), (3, 5, 48), (7, 100)])
@pytest.mark.parametrize("jax_impl", ["pallas", "jnp"])
def test_norm_backward_matches_jax_fp32(fn, shape, jax_impl):
    """dx, dgamma and dbeta through K3's plain path, fp32: atol 1e-5."""
    x, w, b = _inputs(shape)
    dy = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = _grads_jax(fn, x, w, b, dy, jax_impl)
    got = _grads_torch(fn, x, w, b, dy)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fn", ["fused_layer_norm", "fused_rms_norm"])
def test_norm_backward_mixed_bf16_fp32(fn):
    """The O5 mix: bf16 activations with fp32 gamma/beta. dx comes back
    bf16 (one rounding of the same fp32 value: within one bf16 ulp) and the
    parameter grads fp32."""
    x, w, b = _inputs((16, 64))
    x = x.astype(jnp.bfloat16)
    dy = np.random.default_rng(2).standard_normal((16, 64)).astype(jnp.bfloat16)
    ref = _grads_jax(fn, np.asarray(x), w, b, np.asarray(dy, np.float32), "jnp")
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    for t in (xt, wt, bt):
        t.requires_grad_(True)
    y = _call(tnorm, fn, xt, wt, bt, None)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(np.asarray(dy, np.float32))).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(ref[0], np.float32),
                               rtol=2 ** -7, atol=1e-5)
    for g, r in zip((wt.grad, bt.grad), ref[1:]):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=1e-5)


def test_kernel_backward_wrapper_refuses_cpu_tensors():
    """K3's wrapper launches on CUDA tensors or raises; it never falls back."""
    x, w, _ = (torch.from_numpy(a) for a in _inputs((4, 16)))
    with pytest.raises(ValueError):
        tnorm.ln_bwd_kernel(x, w, x, 1e-5, False)


@pytest.mark.parametrize("hidden", [1, 6, 48, 768, 1000, 1024, 1025, 4096, 8192,
                                    8193, 16384])
@pytest.mark.parametrize("x_size, dy_size", [(2, 2), (4, 4), (2, 4), (4, 2)])
def test_k3_geometry_fits_an_h100(hidden, x_size, dy_size):
    """K3's launch from ``ln_bwd_geometry``: every unit of 4 columns has a
    lane, the teams fill a block of 8 warps, each persistent block (one
    partial row of dgamma/dbeta) has a row to start on, and the shared
    memory (fp32 w, the reductions, the ring or the teams' dgamma/dbeta
    rows) fits the blocks an SM is meant to hold."""
    up16 = lambda n: -(-n // 16) * 16  # noqa: E731
    for rows in (1, 5, 2113, 16384):
        geo = tnorm.ln_bwd_geometry(rows, hidden, x_size, dy_size, 132)
        team, nu, teams = geo["team_warps"], geo["nu"], geo["teams"]
        assert team in (1, 2, 4, 8) and team * teams == 8
        assert -(-hidden // 4) <= 32 * team * nu
        per_sm = 2 if nu == 8 else 1
        assert 1 <= geo["blocks"] <= 132 * per_sm
        assert (geo["blocks"] - 1) * teams < max(rows, 1)
        assert 1 <= geo["stages"] <= 3
        head = up16(4 * hidden) + 2 * 8 * 4 * 4
        row = up16(hidden * x_size) + up16(hidden * dy_size)
        ring = geo["stages"] * teams * row
        acc = teams * 2 * 4 * -(-hidden // 4) * 4
        assert geo["smem"] == head + max(ring, acc)
        assert geo["smem"] <= 227 * 1024
        assert per_sm * (geo["smem"] + 1024) <= 228 * 1024


_K1_ROWS = (1, 32, 77, 4096, 16384)


@pytest.mark.parametrize("x_size, y_size", [(2, 2), (4, 4), (2, 4), (4, 2)])
def test_k1_geometry_fits_an_h100_at_every_width(x_size, y_size):
    """K1's launch from ``ln_fwd_geometry`` at every width 1..16384: every
    unit of 8 columns has a lane, the team (and a lane's units) follow from
    the width alone, never from the rows or the dtypes, so a row's bits
    never depend on the call; the teams fit a block of at most 8 warps,
    every persistent block has a row to start on and the grid's stride
    walks every row; the cross-warp sums, fp32 gamma and beta and a ring of
    at least two stages (one only at the widest fp32 rows) fit the blocks
    an SM is meant to hold; the output's size changes nothing."""
    for hidden in range(1, 16385):
        plans = [tnorm.ln_fwd_geometry(rows, hidden, x_size, y_size, 132)
                 for rows in _K1_ROWS]
        team, nu = plans[0]["team_warps"], plans[0]["nu"]
        assert team in (1, 2, 4, 8) and nu in (4, 8)
        assert -(-hidden // 8) <= 32 * team * nu
        for rows, geo in zip(_K1_ROWS, plans):
            assert (geo["team_warps"], geo["nu"]) == (team, nu)
            teams, blocks, per_sm = geo["teams"], geo["blocks"], geo["blocks_per_sm"]
            assert 1 <= teams and team * teams <= 8
            assert per_sm in ((4, 2, 1) if nu == 4 else (1,))
            assert 1 <= blocks <= 132 * per_sm
            assert (blocks - 1) * teams < rows
            assert 1 <= geo["stages"] <= 3
            assert geo["stages"] >= 2 or (per_sm == 1 and teams == 1)
            units = -(-hidden // 8)
            head = (2 * 8 * 4 if team > 1 else 0) + 2 * 4 * 8 * units
            ring = geo["stages"] * teams * 8 * units * x_size
            assert geo["smem"] == head + ring
            assert geo["smem"] <= 227 * 1024
            assert per_sm * (geo["smem"] + 1024) <= 228 * 1024
            assert geo == tnorm.ln_fwd_geometry(rows, hidden, x_size, 6 - y_size, 132)
        assert [(p["team_warps"], p["nu"]) for p in plans] == [
            (p["team_warps"], p["nu"])
            for p in (tnorm.ln_fwd_geometry(rows, hidden, 6 - x_size, y_size, 132)
                      for rows in _K1_ROWS)]


@pytest.mark.parametrize("hidden, team, nu", [
    (1, 1, 4), (8, 1, 4), (1000, 1, 4), (1024, 1, 4), (1025, 2, 4),
    (4096, 4, 4), (8192, 8, 4), (8193, 8, 8), (16384, 8, 8)])
def test_k1_geometry_at_the_paths_widths(hidden, team, nu):
    """A warp owns a row up to hidden 1024 (reductions by shuffles alone),
    a team of 2-8 warps wider rows; the training shape runs 8 teams a block,
    four blocks an SM, three stages; decode's 32 rows spread over 32 SMs,
    one team a block."""
    geo = tnorm.ln_fwd_geometry(16384, hidden, 2, 2, 132)
    assert (geo["team_warps"], geo["nu"]) == (team, nu)
    if hidden == 1024:
        params = 2 * 4 * 1024
        assert geo == dict(team_warps=1, nu=4, teams=8, stages=3, blocks=528,
                           blocks_per_sm=4, smem=params + 3 * 8 * 2048)
        assert tnorm.ln_fwd_geometry(32, 1024, 2, 2, 132) == dict(
            team_warps=1, nu=4, teams=1, stages=3, blocks=32, blocks_per_sm=4,
            smem=params + 3 * 2048)


@pytest.mark.parametrize("hidden", [0, -1, 16385, 32768])
def test_k1_geometry_refuses_widths_it_cannot_take(hidden):
    with pytest.raises(ValueError, match="hidden widths"):
        tnorm.ln_fwd_geometry(32, hidden, 2, 2, 132)


def test_k1_wrapper_refuses_a_width_past_its_widest_row():
    x = torch.zeros(2, 16385)
    with pytest.raises(ValueError):
        tnorm.ln_fwd_kernel(x, torch.ones(16385), None, 1e-5, True, torch.float32)


def _k3_refusals():
    x, w, _ = (torch.from_numpy(a) for a in _inputs((4, 16)))
    wide = torch.zeros(2, 16385)
    return {
        "wide": ((wide, torch.ones(16385), wide), "widest row"),
        "dtype": ((x.double(), w, x.double()), "dtype"),
        "int_w": ((x, w.int(), x), "dtype"),
    }


@pytest.mark.parametrize("case", list(_k3_refusals()))
def test_k3_wrapper_refuses_what_it_does_not_take(case):
    """K3 refuses, before it looks at the device, a width past 16,384 and a
    dtype outside fp32/bf16/fp16 (a CPU tensor: the test above)."""
    (x, w, dy), match = _k3_refusals()[case]
    with pytest.raises(ValueError, match=match):
        tnorm.ln_bwd_kernel(x, w, dy, 1e-5, False)
    if case == "wide":
        with pytest.raises(ValueError):
            tnorm.ln_bwd_geometry(4, 16385, 2, 2, 132)


def test_norm_checks_param_shapes():
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 16)))
    with pytest.raises(ValueError):
        tnorm.fused_layer_norm(x, w[:8], b)
    with pytest.raises(ValueError):
        tnorm.fused_layer_norm(x, w, b[:8])


@pytest.mark.parametrize("impl, want", [(None, "torch"), ("torch", "torch")])
def test_resolve_impl_cpu(impl, want):
    assert resolve_impl(impl, torch.zeros(2), op="layer_norm") == want


@pytest.mark.parametrize("impl", ["kernel", "pallas", "jnp"])
def test_resolve_impl_rejects_impossible(impl):
    with pytest.raises(ValueError):
        resolve_impl(impl, torch.zeros(2), op="layer_norm")


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
