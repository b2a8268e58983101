"""Port parity: Mixture-of-Experts (``beforeholiday_tpu_torch.moe``) and the
GPT's ``moe_every`` blocks, held against the JAX package on the same numpy
inputs, one process, at the JAX MoE tests' sizes (D 32, F 64, T 16, E 8;
the GPT at 4 layers of width 32).

The router's 0/1 decisions are compared bitwise on the same logits; gates,
losses, outputs and gradients within the stated tolerances (PERF.md's
tolerance table says why). Within the port, ``moe_layer`` at sufficient
capacity is held bitwise against ``dense_oracle`` where the CPU's batched
GEMM is row-stable, and the ``save_boundaries`` / ``full`` remat policies
bitwise against no remat. The O5 training step is in
``tests/test_torch_moe_training.py``, the expert-parallel worlds in
``tests/test_torch_moe_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import moe as jm
from beforeholiday_tpu.moe import experts as jexperts
from beforeholiday_tpu.ops._autocast import quantized_compute as j_quantized
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import moe as tm
from beforeholiday_tpu_torch.moe import experts as texperts
from beforeholiday_tpu_torch.ops._autocast import quantized_compute as t_quantized
from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_paths, tree_unflatten
from beforeholiday_tpu_torch.testing import gpt as tgpt

BF16_ULP = 2.0 ** -7
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _setup(seed=0, n_experts=8, top_k=2, capacity_factor=8.0, D=32, F=64, T=16):
    """``tests/test_moe.py``'s fixture as numpy: router weights, tokens and
    the JAX package's expert init (fp32). The large capacity factor drops
    nothing."""
    rng = np.random.RandomState(seed)
    kw = dict(n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor)
    params = jax.tree.map(np.asarray, jm.init_experts(jax.random.PRNGKey(seed),
                                                      n_experts, D, F))
    w_router = rng.randn(D, n_experts).astype(np.float32) * 0.1
    x = rng.randn(T, D).astype(np.float32)
    return jm.MoEConfig(**kw), tm.MoEConfig(**kw), params, w_router, x


def _t(a, dtype=None, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    t = t if dtype is None else t.to(dtype)
    return t.requires_grad_(True) if grad else t


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, dtype=np.float32)).astype(dtype)


def _np(t):
    t = t.detach() if isinstance(t, torch.Tensor) else t
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _tparams(params, dtype=None, grad=False):
    return {k: _t(v, dtype, grad) for k, v in params.items()}


# ---------------------------------------------------------------- router


def test_config_validation_and_capacity():
    with pytest.raises(ValueError):
        tm.MoEConfig(n_experts=4, top_k=3)
    with pytest.raises(ValueError):
        tm.MoEConfig(n_experts=1)
    for E, k, cf, T in ((8, 2, 1.25, 16), (64, 1, 1.0, 4), (4, 2, 1.25, 16384),
                        (4, 2, 8.0, 4096), (8, 1, 0.5, 100)):
        assert tm.MoEConfig(E, k, cf).capacity(T) == jm.MoEConfig(E, k, cf).capacity(T)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [None, 3], ids=["sufficient", "tight"])
def test_route_matches_jax(top_k, capacity):
    """On the same logits: dispatch bitwise; combine, aux and z within fp32
    rounding (the softmax and logsumexp sum in another order); the drop
    fraction exactly. The port's fp32 router logits against JAX's: rtol
    1e-6, atol 1e-6."""
    cfg_j, cfg_t, _, w, x = _setup(top_k=top_k)
    C = cfg_t.capacity(16) if capacity is None else capacity
    lj = jm.router_logits(_j(x), _j(w))
    lt = tm.router_logits(_t(x), _t(w))
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-6, atol=1e-6)
    dj = jax.jit(lambda l: jm.route(l, cfg_j, C))(lj)
    dt = tm.route(_t(np.asarray(lj)), cfg_t, C)
    np.testing.assert_array_equal(_np(dt.dispatch), _np(dj.dispatch))
    np.testing.assert_allclose(_np(dt.combine), _np(dj.combine), rtol=0, atol=1e-6)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(getattr(dt, k)), float(getattr(dj, k)),
                                   rtol=1e-6)
    assert float(dt.drop_fraction) == float(dj.drop_fraction)
    assert (float(dt.drop_fraction) == 0.0) == (capacity is None)


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_gates(top_k):
    """``route(...).combine.sum(-1)`` is ``dense_gates`` bitwise at
    sufficient capacity, losses too (one ``_topk``); the gates against
    JAX's within fp32 rounding (atol 1e-6)."""
    cfg_j, cfg_t, _, w, x = _setup(top_k=top_k)
    lt = tm.router_logits(_t(x), _t(w))
    dec = tm.route(lt, cfg_t, cfg_t.capacity(16))
    gates, aux, z = tm.dense_gates(lt, cfg_t)
    assert float(dec.drop_fraction) == 0.0
    assert torch.equal(dec.combine.sum(-1), gates)
    assert torch.equal(dec.aux_loss, aux) and torch.equal(dec.z_loss, z)
    gj, auxj, zj = jm.dense_gates(_j(lt.numpy()), cfg_j)
    np.testing.assert_allclose(_np(gates), _np(gj), rtol=0, atol=1e-6)
    np.testing.assert_allclose([float(aux), float(z)], [float(auxj), float(zj)],
                               rtol=1e-6)
    if top_k == 2:
        np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_capacity_drop_fraction_analytic():
    """Every token on the same expert pair: expert 0 keeps the first C first
    choices, expert 1 the first C second choices (the analytic
    ``min(n_e, capacity)``); later tokens drop entirely and their combine
    rows are zero. Top-1: ``1 - C / T``."""
    T, E, C = 16, 4, 3
    logits = torch.tensor([4.0, 2.0, 0.0, -2.0]).repeat(T, 1)
    dec = tm.route(logits, tm.MoEConfig(n_experts=E, top_k=2), C)
    assert float(dec.dispatch.sum()) == 2 * C
    assert float(dec.drop_fraction) == pytest.approx(1.0 - 2 * C / (2 * T))
    kept = dec.dispatch.sum((1, 2))
    assert (kept[:C] == 2.0).all() and (kept[C:] == 0.0).all()
    assert (dec.combine[C:] == 0.0).all()
    dec1 = tm.route(logits, tm.MoEConfig(n_experts=E, top_k=1), C)
    assert float(dec1.drop_fraction) == pytest.approx(1.0 - C / T)


def test_dropped_tokens_pass_through_residual():
    """``moe_layer`` gives a dropped token an all-zero row."""
    T, E = 16, 4
    cfg = tm.MoEConfig(n_experts=E, top_k=1)
    params = _tparams(jax.tree.map(np.asarray, jm.init_experts(
        jax.random.PRNGKey(0), E, 8, 16)))
    w = torch.zeros(8, E)
    w[:, 0] = 1.0
    x = torch.from_numpy(np.abs(np.random.RandomState(0).randn(T, 8)).astype(
        np.float32)) + 0.1
    y, aux = tm.moe_layer(x, w, params, cfg, capacity=3)
    assert float(aux["moe_drop_fraction"]) > 0.0
    assert (y[3:] == 0.0).all() and (y[:3].abs() > 0.0).any()


def test_router_loss_gradients_vs_numpy():
    """The Switch aux-loss gradient flows through P only, and the z-loss
    gradient is ``(2 / T) lse P``: the closed forms of ``tests/test_moe.py``
    in float64, rtol 1e-5, atol 1e-8 (the JAX tests' bound)."""
    _, cfg, _, w, x = _setup()
    logits = tm.router_logits(_t(x), _t(w)).detach()
    T, E = logits.shape
    L = logits.double().numpy()
    P_ = np.exp(L - L.max(-1, keepdims=True))
    P_ /= P_.sum(-1, keepdims=True)
    f = np.zeros(E)
    np.add.at(f, P_.argmax(-1), 1.0 / T)
    inner = (P_ * f[None, :]).sum(-1, keepdims=True)
    lse = np.log(np.exp(L).sum(-1))
    want = {"aux_loss": (E / T) * (P_ * f[None, :] - P_ * inner),
            "z_loss": (2.0 / T) * lse[:, None] * P_}
    for name, ref in want.items():
        lg = logits.clone().requires_grad_(True)
        getattr(tm.route(lg, cfg, cfg.capacity(T)), name).backward()
        np.testing.assert_allclose(lg.grad.numpy(), ref, rtol=1e-5, atol=1e-8)


# ----------------------------------------------------------------- experts


@pytest.mark.parametrize("emulate", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_jax(dtype, emulate):
    """``expert_ffn`` on (E, C, D) slots against JAX's, and its VJP: fp32
    rtol 1e-5, atol 1e-6; bf16 one ulp (rtol 2^-7) and atol 2^-7 of the
    largest value (JAX's jit keeps gelu's intermediates in fp32 and rounds
    once; PyTorch's bf16 gelu too, but the bias add before it rounds in
    either order)."""
    _, _, params, _, _ = _setup()
    x = np.random.RandomState(9).randn(8, 4, 32).astype(np.float32)
    dy = np.random.RandomState(10).randn(8, 4, 32).astype(np.float32)
    jdt, tdt = JDT[dtype], TDT[dtype]
    yj, vjp = jax.vjp(lambda a, p: jm.expert_ffn(p, a, emulate_tensor=emulate),
                      _j(x, jdt), jax.tree.map(_j, params))
    dxj, dpj = vjp(_j(dy, jdt))
    tx, tp = _t(x, tdt, grad=True), _tparams(params, grad=True)
    yt = tm.expert_ffn(tp, tx, emulate_tensor=emulate)
    assert yt.dtype == tdt
    yt.backward(_t(dy, tdt))
    pairs = [(yt, yj), (tx.grad, dxj)] + [(tp[k].grad, dpj[k]) for k in params]
    for got, ref in pairs:
        got, ref = _np(got), _np(ref)
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(got, ref, rtol=BF16_ULP,
                                       atol=BF16_ULP * np.abs(ref).max())
    with pytest.raises(ValueError):
        tm.expert_ffn(tp, tx, tensor_axis="tensor", emulate_tensor=2)


def test_expert_tensor_emulation_close_to_unchunked():
    """``emulate_tensor`` regroups the d_ff sum: close, not bitwise (rtol
    1e-5, atol 1e-6, as in JAX)."""
    _, _, params, _, _ = _setup()
    x = _t(np.random.RandomState(9).randn(8, 4, 32))
    tp = _tparams(params)
    np.testing.assert_allclose(tm.expert_ffn(tp, x).numpy(),
                               tm.expert_ffn(tp, x, emulate_tensor=2).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_param_specs_and_init(monkeypatch):
    """The specs are JAX's; ``init_experts`` draws the reference's
    distributions and puts them where the caller asks, the CPU only when
    asked (with no card and no ``device`` it raises, as every entry point
    of the port does)."""
    specs = tm.expert_param_specs(expert_axis="expert", tensor_axis="tensor")
    jspecs = jm.expert_param_specs(expert_axis="expert", tensor_axis="tensor")
    assert {k: tuple(v) for k, v in jspecs.items()} == specs
    g = torch.Generator().manual_seed(0)
    p = tm.init_experts(g, 4, 16, 32, init_std=0.02, out_std=0.01, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wi": (4, 16, 32), "bi": (4, 32), "wo": (4, 32, 16), "bo": (4, 16)}
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in p.values())
    assert abs(float(p["wi"].std()) - 0.02) < 0.002
    assert abs(float(p["wo"].std()) - 0.01) < 0.001
    assert (p["bi"] == 0).all() and (p["bo"] == 0).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_experts(torch.Generator().manual_seed(0), 4, 16, 32)


# ------------------------------------------------------------ the layer


def _layer_grads(layer, x, w, params, dtype, lib):
    """``sum(y^2) + aux + z`` and its gradients w.r.t. (w_router, params,
    x), in ``lib`` ("jax" or "torch")."""
    if lib == "jax":
        def f(ww, pp, xx):
            y, aux = layer(xx, ww, pp)
            return (jnp.sum(jnp.square(y.astype(jnp.float32)))
                    + aux["moe_aux_loss"] + aux["moe_z_loss"]), (y, aux)
        (_, (y, aux)), g = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(_j(w), jax.tree.map(_j, params),
                                                  _j(x, dtype))
        return y, aux, g
    tw, tp, tx = _t(w, grad=True), _tparams(params, grad=True), _t(x, dtype, grad=True)
    y, aux = layer(tx, tw, tp)
    (y.float().square().sum() + aux["moe_aux_loss"] + aux["moe_z_loss"]).backward()
    return y, aux, (tw.grad, {k: v.grad for k, v in tp.items()}, tx.grad)


# fp32: rtol 1e-5, atol 1e-6 of the largest value; bf16: the outputs and the
# token gradients one ulp (rtol 2^-7) plus atol 2^-7 of the largest value,
# the weight gradients (sums over slots of bf16 products) twice that
LAYER_TOL = {"float32": (1e-5, 1e-6, 1.0), "bfloat16": (BF16_ULP, BF16_ULP, 2.0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_and_oracle_match_jax(dtype):
    """``moe_layer`` (capacity factor 1.25: tokens drop) and
    ``dense_oracle`` against JAX's: outputs, aux scalars and the gradients
    of ``sum(y^2) + aux + z`` w.r.t. the router, the experts and x."""
    rtol, atol, wmul = LAYER_TOL[dtype]
    cfg_j, cfg_t, params, w, x = _setup(capacity_factor=1.25)
    jdt, tdt = JDT[dtype], TDT[dtype]
    for jl, tl in ((lambda xx, ww, pp: jm.moe_layer(xx, ww, pp, cfg_j),
                    lambda xx, ww, pp: tm.moe_layer(xx, ww, pp, cfg_t)),
                   (lambda xx, ww, pp: jm.dense_oracle(xx, ww, pp, cfg_j),
                    lambda xx, ww, pp: tm.dense_oracle(xx, ww, pp, cfg_t))):
        yj, auxj, gj = _layer_grads(jl, x, w, params, jdt, "jax")
        yt, auxt, gt = _layer_grads(tl, x, w, params, tdt, "torch")
        assert yt.dtype == tdt and set(auxt) == set(auxj)
        for k in auxj:
            np.testing.assert_allclose(float(auxt[k].detach()), float(auxj[k]), rtol=1e-6)
        pairs = [(yt, yj, 1.0), (gt[0], gj[0], wmul), (gt[2], gj[2], 1.0)]
        pairs += [(gt[1][k], gj[1][k], wmul) for k in params]
        for got, ref, mul in pairs:
            got, ref = _np(got), _np(ref)
            np.testing.assert_allclose(got, ref, rtol=rtol * mul,
                                       atol=atol * mul * np.abs(ref).max())
    assert float(auxt["moe_drop_fraction"]) == 0.0
    assert float(tm.moe_layer(_t(x), _t(w), _tparams(params), cfg_t)[1][
        "moe_drop_fraction"]) > 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_port_oracle(dtype):
    """At sufficient capacity, within the port: the forward and the router
    and token gradients bitwise (the slots are moved by index, the final sum
    has the oracle's shape, and this CPU's batched GEMM gives a row the same
    bits at C = 4 and T = 16 rows); the expert weight gradients sum over
    slots rather than tokens, rtol 1e-5 (fp32) or one bf16 ulp, atol 1e-6 of
    the largest value."""
    _, cfg, params, w, x = _setup()
    tdt = TDT[dtype]
    ym, auxm, gm = _layer_grads(lambda xx, ww, pp: tm.moe_layer(xx, ww, pp, cfg),
                                x, w, params, tdt, "torch")
    yo, auxo, go = _layer_grads(lambda xx, ww, pp: tm.dense_oracle(xx, ww, pp, cfg),
                                x, w, params, tdt, "torch")
    assert float(auxm["moe_drop_fraction"]) == 0.0
    assert torch.equal(ym, yo)
    assert torch.equal(auxm["moe_aux_loss"], auxo["moe_aux_loss"])
    assert torch.equal(auxm["moe_z_loss"], auxo["moe_z_loss"])
    assert torch.equal(gm[0], go[0]) and torch.equal(gm[2], go[2])
    rtol = 1e-5 if dtype == "float32" else BF16_ULP
    for k in params:
        ref = _np(go[1][k])
        np.testing.assert_allclose(_np(gm[1][k]), ref, rtol=rtol,
                                   atol=1e-6 * np.abs(ref).max())


def test_hierarchical_requires_axis_pair():
    with pytest.raises(ValueError):
        tm.expert_all_to_all(torch.zeros(4, 2, 8), "expert", site="moe.dispatch",
                             hierarchical=True)


def test_quantized_moe_matches_jax():
    """O6 (``quantized_compute``): the grouped GEMM's products from the
    same fp8 operands within the fp32 summation bound of
    ``tests/test_torch_quantized.py`` (K 2^-24 sum|a||b| times the output
    scale) against JAX's; the layer deterministic, quantized, and within JAX's
    own O6 MoE tolerance of JAX's (atol 0.1 of the fp32 layer's largest
    output, ``tests/test_moe.py:548``)."""
    from beforeholiday_tpu_torch.ops import quantized as tq

    cfg_j, cfg_t, params, w, x = _setup()
    xs = np.random.RandomState(7).randn(8, 4, 32).astype(np.float32)
    with j_quantized():
        gj = jax.jit(lambda a, b: jexperts._grouped_matmul(a, b))(
            _j(xs), _j(params["wi"]))
        yj = jax.jit(lambda xx: jm.moe_layer(xx, _j(w), jax.tree.map(_j, params),
                                             cfg_j)[0])(_j(x))
    with t_quantized():
        gt = texperts.grouped_matmul(_t(xs), _t(params["wi"]))
        y1 = tm.moe_layer(_t(x), _t(w), _tparams(params), cfg_t)[0]
        y2 = tm.moe_layer(_t(x), _t(w), _tparams(params), cfg_t)[0]
    for e in range(8):
        a, b = _t(xs[e]), _t(params["wi"][e])
        sa = tq._jit_scale(tq._amax(a), tq.E4M3_MAX)
        sb = tq._jit_scale(tq._amax(b), tq.E4M3_MAX)
        qa, qb = tq._q_e4m3(a, sa), tq._q_e4m3(b, sb)
        bound = 32 * 2.0 ** -24 * (qa.float().abs() @ qb.float().abs()) / float(sa * sb)
        assert ((gt[e] - _t(np.asarray(gj[e]))).abs() <= bound).all()
    y32 = tm.moe_layer(_t(x), _t(w), _tparams(params), cfg_t)[0]
    assert torch.equal(y1, y2) and not torch.equal(y1, y32)
    scale = float(y32.abs().max())
    np.testing.assert_allclose(y1.numpy() / scale, np.asarray(yj) / scale, atol=0.1)


# --------------------------------------------------------------- the GPT

GPT_KW = dict(vocab_size=64, seq_len=16, d_model=32, n_heads=2, n_layers=4,
              moe_every=2, moe_experts=4)


@pytest.fixture(scope="module")
def gpt_ref():
    """The JAX MoE GPT (4 layers, 2 MoE groups, capacity factor 1.25, fp32,
    unfused attention) on one batch: logits, aux, loss and gradients."""
    cfg = jgpt.GPTConfig(**GPT_KW, use_flash_attention=False)
    params = jgpt.init(jax.random.PRNGKey(0), cfg)
    tok, tgt = jgpt.synthetic_batch(jax.random.PRNGKey(1), cfg, 2)
    logits, aux = jax.jit(lambda p: jgpt.forward(p, tok, cfg, return_aux=True))(params)
    (loss, aux2), g = jax.jit(jax.value_and_grad(
        lambda p: jgpt.loss_and_aux(p, tok, tgt, cfg), has_aux=True))(params)
    gfn = jax.jit(jax.grad(lambda p: jgpt.loss_fn(p, tok, tgt, cfg)))(params)
    return dict(params=jax.tree.map(np.asarray, params), tok=np.asarray(tok),
                tgt=np.asarray(tgt), logits=np.asarray(logits),
                aux=jax.tree.map(float, aux), loss=float(loss),
                grads=jax.tree.map(np.asarray, g),
                grads_loss_fn=jax.tree.map(np.asarray, gfn))


def _port_loss_grads(np_params, tok, tgt, cfg, fn="loss_and_aux"):
    params = tgpt.params_from_numpy(np_params, device="cpu")
    leaves, treedef = tree_flatten(params)
    leaves = [t.requires_grad_(True) for t in leaves]
    p = tree_unflatten(treedef, leaves)
    tok, tgt = (torch.from_numpy(np.array(a)).long() for a in (tok, tgt))
    if fn == "loss_and_aux":
        loss, aux = tgpt.loss_and_aux(p, tok, tgt, cfg)
    else:
        loss, aux = tgpt.loss_fn(p, tok, tgt, cfg), None
    loss.backward()
    return loss.detach(), aux, tree_unflatten(treedef, [t.grad for t in leaves])


def test_gpt_moe_params_carried_from_jax(gpt_ref):
    """``params_from_numpy`` carries the ``moe`` subtree bit for bit; the
    port's ``init`` and ``param_specs`` have the reference's tree."""
    np_params = gpt_ref["params"]
    p = tgpt.params_from_numpy(np_params, device="cpu")
    assert p["moe"]["w_router"].shape == (2, 32, 4)
    assert p["moe"]["experts"]["wi"].shape == (2, 4, 32, 128)
    for path, got in zip(tree_paths(p), tree_flatten(p)[0]):
        ref = np_params
        for k in path:
            ref = ref[k]
        np.testing.assert_array_equal(got.numpy(), ref)
    cfg = tgpt.GPTConfig(**GPT_KW)
    mine = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tree_paths(mine) == tree_paths(p)
    assert [tuple(a.shape) for a in tree_flatten(mine)[0]] == \
        [tuple(a.shape) for a in tree_flatten(p)[0]]
    assert tree_paths(tgpt.param_specs(cfg)) != []
    assert set(tgpt.param_specs(cfg)["moe"]["experts"]) == {"wi", "bi", "wo", "bo"}
    with pytest.raises(ValueError):
        tgpt.GPTConfig(**{**GPT_KW, "n_layers": 3})


def test_gpt_moe_forward_loss_grads_match_jax(gpt_ref):
    """fp32: logits atol 1e-5, aux scalars rtol 1e-5 (the drop fraction
    exactly), the loss rtol 1e-6, every gradient atol 1e-6 of its leaf's
    largest value + rtol 1e-4; the MoE layers' dense MLP slots get exactly
    zero gradient; ``loss_fn`` is ``loss_and_aux``'s loss."""
    cfg = tgpt.GPTConfig(**GPT_KW, use_flash_attention=False)
    p = tgpt.params_from_numpy(gpt_ref["params"], device="cpu")
    tok = torch.from_numpy(np.array(gpt_ref["tok"])).long()
    logits, aux = tgpt.forward(p, tok, cfg, return_aux=True)
    np.testing.assert_allclose(logits.numpy(), gpt_ref["logits"], rtol=0, atol=1e-5)
    assert float(aux["moe_drop_fraction"]) == gpt_ref["aux"]["moe_drop_fraction"]
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), gpt_ref["aux"][k], rtol=1e-5)
    loss, _, grads = _port_loss_grads(gpt_ref["params"], gpt_ref["tok"],
                                      gpt_ref["tgt"], cfg)
    np.testing.assert_allclose(float(loss), gpt_ref["loss"], rtol=1e-6)
    for ref_key, fn in (("grads", "loss_and_aux"), ("grads_loss_fn", "loss_fn")):
        if fn == "loss_fn":
            _, _, grads = _port_loss_grads(gpt_ref["params"], gpt_ref["tok"],
                                           gpt_ref["tgt"], cfg, fn)
        refs = gpt_ref[ref_key]
        for path, got in zip(tree_paths(grads), tree_flatten(grads)[0]):
            ref = refs
            for k in path:
                ref = ref[k]
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=str(path))
    for k in ("wi", "bi", "wo2", "bo2"):
        g = grads["blocks"][k]
        assert (g[1] == 0).all() and (g[3] == 0).all()
        assert (g[0] != 0).any() and (g[2] != 0).any()
    assert float(grads["moe"]["w_router"].norm()) > 0.0


def test_gpt_dense_path_unchanged():
    """``moe_every=0``: no ``moe`` subtree, ``forward`` bitwise with and
    without ``return_aux``, the aux all zero, the loss plain CE."""
    cfg = tgpt.GPTConfig(**{**GPT_KW, "moe_every": 0, "n_layers": 2})
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "moe" not in params
    tok, tgt = tgpt.synthetic_batch(cfg, 2, generator=torch.Generator().manual_seed(1),
                                    device="cpu")
    a = tgpt.forward(params, tok, cfg)
    b, aux = tgpt.forward(params, tok, cfg, return_aux=True)
    assert torch.equal(a, b) and all(float(v) == 0.0 for v in aux.values())
    assert torch.equal(tgpt.loss_and_aux(params, tok, tgt, cfg)[0],
                       tgpt._cross_entropy(a, tgt))


@pytest.mark.parametrize("policy", ["save_boundaries", "full"])
def test_gpt_moe_remat_bitwise(gpt_ref, policy):
    """Each MoE group under a remat policy: loss and every gradient bitwise
    the no-remat run (the recompute replays the same ops on the same
    inputs)."""
    base = dict(GPT_KW, use_flash_attention=False)
    l0, _, g0 = _port_loss_grads(gpt_ref["params"], gpt_ref["tok"], gpt_ref["tgt"],
                                 tgpt.GPTConfig(**base))
    l1, _, g1 = _port_loss_grads(gpt_ref["params"], gpt_ref["tok"], gpt_ref["tgt"],
                                 tgpt.GPTConfig(**base, remat_policy=policy))
    assert torch.equal(l0, l1)
    for a, b in zip(tree_flatten(g0)[0], tree_flatten(g1)[0]):
        assert torch.equal(a, b)
