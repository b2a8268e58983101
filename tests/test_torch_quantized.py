"""Port parity: the fp8 tier of amp O6 (``ops.quantized``, the amax history
in the loss scaler, O6 in ``amp`` and the step guard), held against the JAX
package (``tests/test_quantized.py``'s cases that have a meaning in the
port) on the same numpy inputs, on the CPU.

The casts, the scales and the history agree bit for bit. The products are
the same fp8 values multiplied in fp32 by two libraries, so they agree to
the order of an fp32 sum: |Δ| <= K·2⁻²⁴·Σ|â||b̂| per element. Tolerances,
and why, are in PERF.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import amp as jamp
from beforeholiday_tpu.amp.scaler import LossScaler as JScaler
from beforeholiday_tpu.guard.step import StepGuard as JGuard
from beforeholiday_tpu.ops import dense as jdense
from beforeholiday_tpu.ops import quantized as jq
from beforeholiday_tpu.ops._autocast import quantized_compute as jcompute
from beforeholiday_tpu.optimizers import FusedAdam as JFusedAdam
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.amp.scaler import LossScaler as TScaler
from beforeholiday_tpu_torch.guard import StepGuard as TGuard
from beforeholiday_tpu_torch.ops import dense as tdense
from beforeholiday_tpu_torch.ops import quantized as tq
from beforeholiday_tpu_torch.ops._autocast import quantized_compute
from beforeholiday_tpu_torch.optimizers import FusedAdam as TFusedAdam
from beforeholiday_tpu_torch.transformer.tensor_parallel.random import checkpoint


def _np(shape, seed, dtype=np.float32, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.array(a, np.float32)).astype(dtype)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _reset_counts():
    for k in tq.product_counts:
        tq.product_counts[k] = 0


# ------------------------------------------------------------------ casts

# every finite bf16 bit pattern, widened to fp32
_BF16 = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
_BF16 = _BF16[np.isfinite(_BF16)]
# unit; the e4m3 and e5m2 maxima over a typical amax; a power of two that
# shifts values into the subnormals; scales that overflow most values
_SCALES = (1.0, 448.0 / 3.7, 57344.0 / 1.3, 2.0 ** -9, 3.0e4, 1.0e30)


@pytest.mark.parametrize("scale", _SCALES)
def test_casts_bitwise(scale):
    """The saturating e4m3 and the non-saturating e5m2 casts of every bf16
    value times ``scale``: ties, subnormals, the largest finite values and
    overflow (e5m2: ±inf) bit for bit as JAX's (ml_dtypes)."""
    s_t = torch.tensor(scale, dtype=torch.float32)
    s_j = jnp.float32(scale)
    x_t, x_j = torch.from_numpy(_BF16), jnp.asarray(_BF16)
    np.testing.assert_array_equal(_bits(tq._q_e4m3(x_t, s_t)),
                                  _bits(jq._q_e4m3(x_j, s_j)))
    np.testing.assert_array_equal(_bits(tq._q_e5m2(x_t, s_t)),
                                  _bits(jq._q_e5m2(x_j, s_j)))
    np.testing.assert_array_equal(_bits(tq.quantize_e4m3(x_t, scale)),
                                  _bits(jq.quantize_e4m3(x_j, scale)))


def test_casts_at_the_edges():
    """Ties and the ends of each format: e4m3 clips to ±448, never NaN;
    e5m2 rounds up to inf at 61440 and keeps 57343 finite."""
    edge = np.array([448.0, 464.0, 480.0, 1e9, -1e9, 2.0 ** -10, 3 * 2.0 ** -10,
                     57344.0, 61439.0, 61440.0, 2.0 ** -17, 0.0, -0.0],
                    np.float32)
    one_t, one_j = torch.ones(()), jnp.float32(1.0)
    q4 = tq._q_e4m3(torch.from_numpy(edge), one_t)
    q5 = tq._q_e5m2(torch.from_numpy(edge), one_t)
    np.testing.assert_array_equal(_bits(q4), _bits(jq._q_e4m3(jnp.asarray(edge),
                                                               one_j)))
    np.testing.assert_array_equal(_bits(q5), _bits(jq._q_e5m2(jnp.asarray(edge),
                                                               one_j)))
    assert torch.isfinite(q4.float()).all() and q4.float().abs().max() == 448.0
    assert torch.isinf(q5.float()[[4, 9]]).all()
    assert torch.isfinite(q5.float()[[7, 8]]).all()


# ------------------------------------------------- scales and the history


def test_jit_scales_bitwise():
    for seed, amp_ in ((1, 1.0), (2, 3e-3), (3, 7e4)):
        x = _np((17, 9), seed, scale=amp_)
        for margin in (1.0, 2.0, 3.0):
            np.testing.assert_array_equal(
                tq.jit_scale_e4m3(_t(x), margin=margin).numpy(),
                np.asarray(jq.jit_scale_e4m3(_j(x), margin=margin)))
    zero = np.zeros((3, 4), np.float32)
    assert float(tq.jit_scale_e4m3(_t(zero))) == 1.0
    with pytest.raises(ValueError, match="margin"):
        tq.jit_scale_e4m3(_t(zero), margin=0.5)


def test_history_bitwise():
    """init, the roll into slot 0, non-finite observations dropped, the
    scales from the maxima (1.0 for an empty row), ``amax_of_tree`` over
    floating leaves only."""
    th, jh = tq.init_amax_history(3), jq.init_amax_history(3)
    assert th.shape == (len(tq.HISTORY_ROLES), 3) and tq.HISTORY_ROLES == jq.HISTORY_ROLES
    assert [float(s) for s in tq.scales_from_history(th)] == [1.0, 1.0]
    for w, g in ((2.0, 5.0), (3.3, 1e-3), (np.inf, np.nan), (0.7, 12345.6)):
        th = tq.update_amax_history(th, w, g)
        jh = jq.update_amax_history(jh, w, g)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        for margin in (1.0, 2.0):
            for a, b in zip(tq.scales_from_history(th, margin=margin),
                            jq.scales_from_history(jh, margin=margin)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(th.numpy()[:, 1], [0.0, 0.0])  # inf, nan
    with pytest.raises(ValueError, match=">= 1"):
        tq.init_amax_history(0)
    with pytest.raises(ValueError, match="margin"):
        tq.scales_from_history(th, margin=0.5)
    tree_t = {"a": torch.tensor([-3.0, 1.0]), "b": torch.arange(5),
              "c": torch.tensor([[0.5]], dtype=torch.bfloat16)}
    tree_j = {"a": jnp.asarray([-3.0, 1.0]), "b": jnp.arange(5),
              "c": jnp.asarray([[0.5]], jnp.bfloat16)}
    assert float(tq.amax_of_tree(tree_t)) == float(jq.amax_of_tree(tree_j)) == 3.0
    assert float(tq.amax_of_tree({"i": torch.arange(3)})) == 0.0


# ------------------------------------------------------------ the products


def _sum_bound(qa, qb, scale):
    """K·2⁻²⁴·Σ|â||b̂| per output element, times the output scale: two fp32
    sums of the same K products in two orders part by at most this."""
    a, b = qa.float().abs(), qb.float().abs()
    return qa.shape[-1] * 2.0 ** -24 * (a @ b) * scale


@pytest.mark.parametrize("shape,dtype", [((32, 48), "float32"),
                                         ((2, 16, 32), "bfloat16")],
                         ids=["2d-fp32", "3d-bf16"])
def test_quantized_matmul_matches_jax(shape, dtype):
    """Forward and both gradients: the quantized operands bitwise (x, w, the
    cotangent), the products within the fp32 summation bound, the result
    within ``quantized_matmul_error_bound`` of fp32 ``x @ w``, the
    gradients in the primal dtypes."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    K = shape[-1]
    x, w = _np(shape, 3), _np((K, 24), 4)
    dy = _np((*shape[:-1], 24), 5)
    jx, jw = _j(x, jdt), _j(w, jdt)
    y_j, vjp = jax.vjp(lambda a, b: jq.quantized_matmul(a, b), jx, jw)
    dx_j, dw_j = vjp(jnp.asarray(dy))
    tx = _t(np.asarray(jx.astype(jnp.float32)), tdt).requires_grad_()
    tw = _t(np.asarray(jw.astype(jnp.float32)), tdt).requires_grad_()
    y_t = tq.quantized_matmul(tx, tw)
    y_t.backward(torch.from_numpy(dy))
    assert y_t.dtype == torch.float32 and y_t.shape == (*shape[:-1], 24)
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt

    # the operands, quantized as the op quantizes them
    x2, w2 = tx.detach().reshape(-1, K), tw.detach()
    sx = tq._jit_scale(tq._amax(x2), tq.E4M3_MAX)
    sw = tq._jit_scale(tq._amax(w2), tq.E4M3_MAX)
    sg = tq._jit_scale(tq._amax(torch.from_numpy(dy)), tq.E5M2_MAX)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(
        jq._jit_scale(jx.astype(jnp.float32), jq.E4M3_MAX)))
    qx, qw = tq._q_e4m3(x2, sx), tq._q_e4m3(w2, sw)
    qdy = tq._q_e5m2(torch.from_numpy(dy).reshape(-1, 24), sg)
    np.testing.assert_array_equal(_bits(qx), _bits(jq._q_e4m3(
        jx.astype(jnp.float32).reshape(-1, K), jnp.asarray(sx.numpy()))))
    np.testing.assert_array_equal(_bits(qw), _bits(jq._q_e4m3(
        jw.astype(jnp.float32), jnp.asarray(sw.numpy()))))
    np.testing.assert_array_equal(_bits(qdy), _bits(jq._q_e5m2(
        jnp.asarray(dy).reshape(-1, 24), jnp.asarray(sg.numpy()))))

    # the products, within fp32 reordering (the result dtypes' ulp on top
    # for the bf16 gradients)
    checks = (
        (y_t.detach().reshape(-1, 24), y_j.reshape(-1, 24),
         _sum_bound(qx, qw, 1.0 / float(sx * sw)), 0.0),
        (tx.grad.float().reshape(-1, K), dx_j.astype(jnp.float32).reshape(-1, K),
         _sum_bound(qdy, qw.t(), 1.0 / float(sg * sw)), 2.0 ** -8),
        (tw.grad.float(), dw_j.astype(jnp.float32),
         _sum_bound(qx.t(), qdy, 1.0 / float(sx * sg)), 2.0 ** -8),
    )
    for got, ref, bound, ulp in checks:
        ref = torch.from_numpy(np.array(ref))
        assert ((got - ref).abs() <= bound * (1 + ulp) + ulp * ref.abs()).all()
    ref32 = _t(np.asarray(jx.astype(jnp.float32))) @ _t(np.asarray(
        jw.astype(jnp.float32)))
    assert float((y_t.detach() - ref32).abs().max()) <= float(
        tq.quantized_matmul_error_bound(tx.detach(), tw.detach()))


def test_scope_with_exact_scales_is_the_jit_result():
    """Delayed scales equal to the just-in-time ones give the scopeless
    result bitwise: the scope changes where the scale comes from."""
    x, w = _t(_np((16, 32), 7)), _t(_np((32, 16), 8))
    y_jit = tq.quantized_matmul(x, w)
    sw = tq._jit_scale(tq._amax(w), tq.E4M3_MAX)
    with tq.quantized_scope(sw, 1.0):
        y_scoped = tq.quantized_matmul(x, w)
        assert tq.active_scales() is not None
    assert tq.active_scales() is None
    assert torch.equal(y_jit, y_scoped)
    with jq.quantized_scope(float(sw), 1.0):
        y_j = jq.quantized_matmul(_j(x.numpy()), _j(w.numpy()))
    assert float((y_scoped - _t(np.asarray(y_j))).abs().max()) <= float(
        _sum_bound(tq._q_e4m3(x, tq._jit_scale(tq._amax(x), 448.0)),
                   tq._q_e4m3(w, sw), 1.0).max())


def test_errors():
    x_i = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    w = _t(_np((4, 2), 9))
    with pytest.raises(TypeError, match="unsupported dtype"):
        tq.quantized_matmul(x_i, w)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tq.quantized_matmul(w.t(), x_i)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tq.quantized_matmul(w.double(), w.t())
    with pytest.raises(ValueError, match="expects x"):
        tq.quantized_matmul(_t(_np((4, 4), 0)), _t(_np((4, 4, 4), 0)))
    with pytest.raises(ValueError, match="expects x"):
        tq.quantized_matmul(_t(_np((4, 3), 0)), _t(_np((4, 4), 0)))
    with pytest.raises(ValueError, match="impl"):
        tq.quantized_matmul(_t(_np((4, 4), 0)), _t(_np((4, 4), 0)), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):  # no card path on the CPU
        tq.quantized_matmul(_t(_np((4, 4), 0)), _t(_np((4, 4), 0)), impl="kernel")


def test_error_bounds_equal_jax():
    for seed, scale_w in ((1, None), (2, 3.0), (3, 1e4), (4, 0.0)):
        x, w = _np((12, 40), seed), _np((40, 8), seed + 10, scale=0.05)
        kw = {} if scale_w is None else {"scale_w": scale_w}
        assert float(tq.quantized_matmul_error_bound(_t(x), _t(w), **kw)) == \
            float(jq.quantized_matmul_error_bound(_j(x), _j(w), **kw))
    with tq.quantized_scope(200.0, 1.0), jq.quantized_scope(200.0, 1.0):
        x, w = _np((5, 16), 6), _np((16, 4), 7)
        assert float(tq.quantized_matmul_error_bound(_t(x), _t(w))) == \
            float(jq.quantized_matmul_error_bound(_j(x), _j(w)))
    for step, n, ceil in ((0, 8, 6.0), (10, 8, 6.0), (3, 32, 10.4), (49, 8, 6.2)):
        assert tq.loss_parity_bound(step, n_matmuls=n, loss_ceiling=ceil) == \
            jq.loss_parity_bound(step, n_matmuls=n, loss_ceiling=ceil)
    with pytest.raises(ValueError, match="n_matmuls"):
        tq.loss_parity_bound(0, n_matmuls=0, loss_ceiling=6.0)


# ----------------------------------------------------------------- scaler


def _same_state(t, j):
    assert set(t) == set(j)
    for k in t:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_scaler_o6_state_update_and_state_dict():
    ts, js = TScaler(quantized=True, amax_history_len=3), JScaler(
        quantized=True, amax_history_len=3)
    t, j = ts.init(device="cpu"), js.init()
    _same_state(t, j)
    for fi, amax in ((False, (2.0, 7.0)), (True, (np.inf, 9.0)),
                     (False, (1.5, np.nan)), (False, None)):
        t = ts.update(t, torch.tensor(fi), amax=amax)
        j = js.update(j, jnp.bool_(fi), amax=amax)
        _same_state(t, j)
        for a, b in zip(ts.quantized_scales(t), js.quantized_scales(j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sd = ts.state_dict(t)
    assert sd == js.state_dict(j) and isinstance(sd["amax_history"], list)
    back = ts.load_state_dict(sd, device="cpu")
    _same_state(back, js.load_state_dict(js.state_dict(j)))
    # a static scale rolls the history too
    st = TScaler(loss_scale=4.0, quantized=True)
    s2 = st.update(st.init(device="cpu"), torch.tensor(False), amax=(3.0, 4.0))
    assert s2["amax_history"][:, 0].tolist() == [3.0, 4.0]


def test_scaler_state_dicts_load_either_way():
    """A pre-O6 dict into a quantized scaler starts a fresh history; an O6
    dict into a plain scaler keeps its history (as JAX does); a plain
    scaler has no scales."""
    old = TScaler().state_dict(TScaler().init(device="cpu"))
    assert "amax_history" not in old
    new = TScaler(quantized=True, amax_history_len=5).load_state_dict(old, device="cpu")
    _same_state(new, JScaler(quantized=True, amax_history_len=5).load_state_dict(
        JScaler().state_dict(JScaler().init())))
    assert new["amax_history"].shape == (2, 5) and not new["amax_history"].any()
    q = TScaler(quantized=True)
    sd = q.state_dict(q.update(q.init(device="cpu"), torch.tensor(False),
                               amax=(1.0, 2.0)))
    plain = TScaler().load_state_dict(sd, device="cpu")
    _same_state(plain, JScaler().load_state_dict(sd))
    assert TScaler().quantized_scales(TScaler().init(device="cpu")) == (None, None)


# -------------------------------------------------------- amp O6 frontend


def test_initialize_o6_builds_quantized_scalers_and_routes_dense():
    """O6 casts to bf16 as O5 does, builds quantized scalers, and its apply
    sends every ``ops.dense`` GEMM through ``quantized_matmul`` (counted);
    O5's apply sends none."""
    params = {"w": _t(_np((8, 4), 21)), "b": _t(_np((4,), 22))}
    x = _t(_np((6, 8), 23))
    fn = (lambda p, a: tdense.fused_dense(a, p["w"], p["b"]))
    m6 = tamp.initialize(fn, params, TFusedAdam(lr=1e-3), "O6", num_losses=2)
    jm = jamp.initialize(lambda p, a: p, {k: jnp.asarray(v.numpy()) for k, v in
                                          params.items()}, JFusedAdam(lr=1e-3), "O6")
    assert [s.quantized for s in m6.scalers] == [True, True] == [jm.scaler.quantized] * 2
    assert "amax_history" in m6.scaler.init(device="cpu")
    assert m6.params["w"].dtype == torch.bfloat16
    _reset_counts()
    y6 = m6.apply(m6.params, x)
    assert tq.product_counts["plain_forward"] == 1
    m5 = tamp.initialize(fn, params, TFusedAdam(lr=1e-3), "O5")
    _reset_counts()
    y5 = m5.apply(m5.params, x)
    assert sum(tq.product_counts.values()) == 0
    assert y6.dtype == y5.dtype == torch.float32 and not torch.equal(y6, y5)
    assert not tamp.LossScaler().quantized


def test_o6_dense_output_within_matmul_bound():
    x, w = _t(_np((16, 32), 23)), _t(_np((32, 16), 24))
    y_ref = tdense.fused_dense(x, w)
    with quantized_compute():
        y_q = tdense.fused_dense(x, w)
        h = tdense.mlp(x, [w, w[:16, :8]], [torch.zeros(16), torch.zeros(8)])
        g = tdense.fused_dense_gelu_dense(x, w, torch.zeros(16), w[:16, :8],
                                          torch.zeros(8))
    assert float((y_q - y_ref).abs().max()) <= float(
        tq.quantized_matmul_error_bound(x, w))
    assert h.shape == g.shape == (16, 8)
    with jcompute():
        y_j = jdense.fused_dense(_j(x.numpy()), _j(w.numpy()))
    assert float((y_q - _t(np.asarray(y_j))).abs().max()) <= 1e-5 * float(
        y_ref.abs().max())


# ------------------------------------------------------------ step guard


def _guard_run(pkg, poison):
    """One guarded step of ``loss(x @ w)`` on each package: the grad row of
    the history poisoned (amax 1e-30, so the e5m2 cotangent overflows) or
    clean."""
    x, w = _np((6, 8), 17), _np((8, 4), 16)
    if pkg == "jax":
        guard = JGuard(JScaler(quantized=True, amax_history_len=4))
        params = {"w": jnp.asarray(w)}
        gstate = guard.init(params)
        if poison:
            gstate["scaler"]["amax_history"] = gstate["scaler"][
                "amax_history"].at[1, 0].set(1e-30)
        opt = JFusedAdam(lr=1e-2)
        loss_fn = (lambda p: jnp.mean(jq.quantized_matmul(jnp.asarray(x), p["w"]) ** 2))
        ostate = opt.init(params)
    else:
        guard = TGuard(TScaler(quantized=True, amax_history_len=4))
        params = {"w": torch.from_numpy(w)}
        gstate = guard.init(params, device="cpu")
        if poison:
            gstate["scaler"]["amax_history"][1, 0] = 1e-30
        opt = TFusedAdam(lr=1e-2)
        loss_fn = (lambda p: (tq.quantized_matmul(torch.from_numpy(x), p["w"]) ** 2).mean())
        ostate = opt.init(params)
    before = np.array(params["w"], np.float32).copy()
    loss, grads, verdict = guard.value_and_grad(loss_fn)(params, gstate)
    new_p, _, new_g = guard.apply_update(opt, params, grads, ostate, gstate, verdict)
    return dict(before=before, after=np.array(new_p["w"], np.float32),
                overflow=bool(verdict["grad_overflow"]), has_amax="amax" in verdict,
                scale=float(new_g["scaler"]["scale"]),
                skipped=int(new_g["health"]["skipped_total"]),
                history=np.array(new_g["scaler"]["amax_history"], np.float32),
                loss=float(loss))


@pytest.mark.parametrize("poison", [True, False], ids=["overflow", "clean"])
def test_step_guard_o6(poison):
    """Poisoned: found_inf set, the step skipped (params bitwise unchanged),
    the scale halved, the inf observation dropped from the history.
    Clean: both observations rolled into slot 0. Both as JAX's guard."""
    t, j = _guard_run("torch", poison), _guard_run("jax", poison)
    assert t["overflow"] == j["overflow"] == poison
    assert t["has_amax"] and j["has_amax"]
    assert t["scale"] == j["scale"] == 2.0 ** 16 / (2 if poison else 1)
    assert t["skipped"] == j["skipped"] == int(poison)
    assert np.isfinite(t["history"]).all()
    np.testing.assert_allclose(t["history"], j["history"], rtol=1e-6)
    if poison:
        np.testing.assert_array_equal(t["after"], t["before"])
        assert t["history"][1, 1] == np.float32(1e-30)  # rolled, inf dropped
    else:
        assert (t["history"][:, 0] > 0).all()
        assert not np.array_equal(t["after"], t["before"])
        np.testing.assert_allclose(t["after"], j["after"], rtol=0, atol=2e-2 + 1e-6)


# ------------------------------------------------------- checkpoint under O6


def test_checkpoint_reenters_the_quantized_scope():
    """A checkpointed ``fused_dense`` under O6's routing and delayed scales,
    its backward run after the scopes close (as on autograd's thread), gives
    the unchecked op's gradients bitwise: the recompute re-enters the
    forward's routing and scales."""
    x0, w0 = _t(_np((12, 16), 30), torch.bfloat16), _t(_np((16, 8), 31, scale=0.1),
                                                      torch.bfloat16)
    b0 = _t(_np((8,), 32), torch.bfloat16)
    grads = []
    for wrap in (lambda f: f, checkpoint):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        with quantized_compute(), tq.quantized_scope(torch.tensor(900.0),
                                                     torch.tensor(3.0)):
            y = wrap(tdense.fused_dense)(x, w, b0)
        _reset_counts()
        y.float().square().sum().backward()
        grads.append((x.grad, w.grad, dict(tq.product_counts)))
    (dx, dw, c0), (dx_c, dw_c, c1) = grads
    assert torch.equal(dx, dx_c) and torch.equal(dw, dw_c)
    assert c0["plain_backward"] == c1["plain_backward"] == 2
    assert c1["plain_forward"] == 1  # the recompute, quantized again
