"""Port parity: the amp O5, arena-native FusedAdam training step of the GPT
(``bench.py`` ``make_gpt_rung``), held against the JAX package on the same
numpy parameters and batch, at a small size (vocab 512, seq 128, d 128, 4
heads, 2 layers, batch 2).

The JAX side runs its Pallas flash attention, unscale and Adam kernels in
interpret mode (``attention_impl="pallas"``, ``impl="pallas"``); the port
runs the kernels' plain versions (CPU tensors). Tolerances, and why, are in
PERF.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import amp as jamp
from beforeholiday_tpu.optimizers import FusedAdam as JFusedAdam
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.ops.arena import PackedParams
from beforeholiday_tpu_torch.optimizers import FusedAdam as TFusedAdam
from beforeholiday_tpu_torch.testing import gpt as tgpt

SMALL = dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4, n_layers=2)
LR = 1e-3
STEPS = 3
BF16_ULP = 2.0 ** -7  # bf16 spacing relative to the value, at most


def _batch(seed=1, batch=2):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, SMALL["vocab_size"], (batch, SMALL["seq_len"]))
    return tok.astype(np.int32), np.roll(tok, -1, axis=-1).astype(np.int32)


def _jax_run(act_dtype, steps, loss_scale=None, scale=None):
    cfg = jgpt.GPTConfig(**SMALL, dtype=act_dtype, attention_impl="pallas")
    params = jgpt.init(jax.random.PRNGKey(0), cfg)
    m = jamp.initialize(lambda p, t: jgpt.forward(p, t, cfg), params,
                        JFusedAdam(lr=LR, impl="pallas"), "O5",
                        arena_native=True, loss_scale=loss_scale)
    svag = jamp.scaled_value_and_grad(
        lambda p, tok, tgt: jgpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply),
        m.scaler, impl="pallas")

    # eager, as the port runs: under jit XLA's CPU compiler computes some bf16
    # sums in fp32 without the intermediate rounding, and eager JAX does not
    def step(p, o, s, tok, tgt):
        loss, g, fi, s = svag(p, s, tok, tgt)
        p, o = m.optimizer.step(p, g, o, found_inf=fi)
        return p, o, s, loss, g, fi

    p, o, s = m.params, m.optimizer.init(m.params), m.scaler.init()
    if scale is not None:
        s = {**s, "scale": jnp.float32(scale)}
    tok, tgt = (jnp.asarray(a) for a in _batch())
    start = jax.tree.map(np.asarray, (p.arenas, o, s))
    out = []
    for _ in range(steps):
        p, o, s, loss, g, fi = step(p, o, s, tok, tgt)
        out.append(jax.tree.map(np.asarray, dict(
            loss=loss, grads=g.arenas, found_inf=fi, model=p.arenas, opt=o,
            scaler=s)))
    return jax.tree.map(np.asarray, params), start, out


def _port_run(np_params, act_dtype, steps, start=None, loss_scale=None):
    cfg = tgpt.GPTConfig(**SMALL, dtype=act_dtype)
    params = tgpt.params_from_numpy(np_params, device="cpu")
    m = tamp.initialize(lambda p, t: tgpt.forward(p, t, cfg), params,
                        TFusedAdam(lr=LR), "O5", arena_native=True,
                        loss_scale=loss_scale)
    svag = tamp.scaled_value_and_grad(
        lambda p, tok, tgt: tgpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply),
        m.scaler)
    o, s = m.optimizer.init(m.params), m.scaler.init(device="cpu")
    if start is not None:  # continue the JAX run's state
        arenas, o, s = tgpt.state_from_numpy(start, device="cpu")
        for a, b in zip(m.params.arenas, arenas):
            a.copy_(b)
    tok, tgt = (torch.from_numpy(a).long() for a in _batch())
    out = []
    for _ in range(steps):
        loss, g, fi, s = svag(m.params, s, tok, tgt)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        out.append(dict(loss=loss, grads=g.arenas, found_inf=fi,
                        model=[a.clone() for a in m.params.arenas],
                        opt=_clone(o), scaler=dict(s)))
    return m, out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _f32(a):
    return np.asarray(a, dtype=np.float32)


@pytest.fixture(scope="module", params=["fp32_act", "bf16_act"])
def runs(request):
    jdt, tdt = ((jnp.float32, torch.float32) if request.param == "fp32_act"
                else (jnp.bfloat16, torch.bfloat16))
    np_params, start, jout = _jax_run(jdt, STEPS)
    m, tout = _port_run(np_params, tdt, STEPS)
    return request.param, np_params, start, jout, m, tout


# per activation dtype; measured worst cases are in PERF.md's tolerance table
TOL = {
    # fp32 compute over bf16 weights. Step 1: the grads are the same fp32
    # values rounded once to bf16, so they agree to one bf16 ulp. Later
    # steps start from masters that Adam moved apart (below), and the grads
    # may differ by 1e-4 more.
    "fp32_act": dict(loss=1e-5, grad_atol=(1e-6, 1e-4), grad_rtol=BF16_ULP,
                     master=1e-4, sq_atol=1e-6),
    # bf16 activations: every layer rounds to bf16 at other places in the
    # two frameworks; the dense layers round once, as in JAX (the atol is
    # about twice the worst measured, 6.8e-4 at step 1, 4.3e-3 by step 3)
    "bf16_act": dict(loss=1e-3, grad_atol=(2e-3, 1e-2), grad_rtol=BF16_ULP,
                     master=3 * LR, sq_atol=1e-5),
}


def test_packed_layout_matches_jax(runs):
    """Same buckets, offsets and padding; the model arenas at init are the
    same bf16/fp32 casts of the same parameters, bit for bit."""
    _, np_params, start, _, m, _ = runs
    params = tgpt.params_from_numpy(np_params, device="cpu")
    fresh = tamp.initialize(lambda p, t: p, params, TFusedAdam(lr=LR), "O5",
                            arena_native=True).params
    assert [a.dtype for a in fresh.arenas] == [torch.bfloat16, torch.float32]
    for got, ref in zip(fresh.arenas, start[0]):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(_np(got), _f32(ref))


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_jax(runs, step):
    """Loss, found_inf, grad arenas, masters, moments, model arenas, step
    count and scaler state after each of three steps."""
    name, _, _, jout, _, tout = runs
    tol = TOL[name]
    g_atol, g_rtol = tol["grad_atol"][min(step, 1)], tol["grad_rtol"]
    j, t = jout[step], tout[step]
    np.testing.assert_allclose(t["loss"].item(), float(j["loss"]), rtol=tol["loss"])
    assert bool(t["found_inf"]) == bool(j["found_inf"]) is False
    for got, ref in zip(t["grads"], j["grads"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _f32(ref), atol=g_atol, rtol=g_rtol)
    for b in range(2):
        jo, to = j["opt"]["inner"][b], t["opt"]["inner"][b]
        assert int(to["step"]) == int(jo["step"]) == step + 1
        # Adam's normalised update turns a grad that flips sign near zero
        # into a 2 lr difference; the bound grows with each step
        np.testing.assert_allclose(_np(t["opt"]["master"][b]),
                                   _f32(j["opt"]["master"][b]),
                                   atol=tol["master"] * (step + 1), rtol=0)
        np.testing.assert_allclose(_np(to["exp_avg"]), _f32(jo["exp_avg"]),
                                   atol=g_atol, rtol=g_rtol)
        np.testing.assert_allclose(_np(to["exp_avg_sq"]), _f32(jo["exp_avg_sq"]),
                                   atol=tol["sq_atol"], rtol=2 * g_rtol)
        # the model arena is the master cast to its dtype, bit for bit
        np.testing.assert_array_equal(
            _np(t["model"][b]),
            _np(t["opt"]["master"][b].to(t["model"][b].dtype)))
    for key in ("scale", "unskipped", "consecutive_overflows"):
        assert t["scaler"][key].item() == j["scaler"][key].item()


def test_continued_from_jax_state(runs):
    """state_from_numpy: the port continues the JAX run from its step-2
    state and lands on the JAX step-3 masters and moments."""
    name, np_params, _, jout, _, _ = runs
    tol = TOL[name]
    j2, j3 = jout[1], jout[2]
    tdt = torch.float32 if name == "fp32_act" else torch.bfloat16
    _, tout = _port_run(np_params, tdt, 1,
                        start=(j2["model"], j2["opt"], j2["scaler"]))
    t3 = tout[0]
    np.testing.assert_allclose(t3["loss"].item(), float(j3["loss"]),
                               rtol=tol["loss"])
    for b in range(2):
        assert int(t3["opt"]["inner"][b]["step"]) == 3
        np.testing.assert_allclose(_np(t3["opt"]["master"][b]),
                                   _f32(j3["opt"]["master"][b]),
                                   atol=tol["master"], rtol=0)


def test_loss_falls_on_a_fixed_batch(runs):
    tout = runs[-1]
    losses = [t["loss"].item() for t in tout]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ---------------------------------------------------------------- skip step
#
# bf16 shares fp32's exponent range, so at this size no loss scale makes the
# scaled bf16 grads overflow: they stay below 1, and a scale above 2**126
# has a subnormal inverse, which XLA's CPU backend flushes to zero. The skip
# step therefore injects the overflow the way the JAX package's own amp
# tests do (tests/test_amp.py): the loss is multiplied by inf, so every
# gradient is inf or NaN.


def _jax_skip():
    cfg = jgpt.GPTConfig(**SMALL, attention_impl="pallas")
    params = jgpt.init(jax.random.PRNGKey(0), cfg)
    m = jamp.initialize(lambda p, t: jgpt.forward(p, t, cfg), params,
                        JFusedAdam(lr=LR, impl="pallas"), "O5",
                        arena_native=True, loss_scale="dynamic")
    svag = jamp.scaled_value_and_grad(
        lambda p, tok, tgt: jgpt.loss_fn(p, tok, tgt, cfg,
                                         forward_fn=m.apply) * jnp.inf,
        m.scaler, impl="pallas")
    p, o, s = m.params, m.optimizer.init(m.params), m.scaler.init()
    before = jax.tree.map(np.asarray, (p.arenas, o))
    _, g, fi, s = svag(p, s, *(jnp.asarray(a) for a in _batch()))
    p, o = m.optimizer.step(p, g, o, found_inf=fi)
    return jax.tree.map(np.asarray, params), before, jax.tree.map(
        np.asarray, (p.arenas, o, s, fi))


@pytest.fixture(scope="module")
def skipped():
    np_params, jbefore, jafter = _jax_skip()
    cfg = tgpt.GPTConfig(**SMALL)
    m = tamp.initialize(
        lambda p, t: tgpt.forward(p, t, cfg),
        tgpt.params_from_numpy(np_params, device="cpu"), TFusedAdam(lr=LR),
        "O5", arena_native=True, loss_scale="dynamic")
    svag = tamp.scaled_value_and_grad(
        lambda p, tok, tgt: tgpt.loss_fn(p, tok, tgt, cfg,
                                         forward_fn=m.apply) * float("inf"),
        m.scaler)
    o, s = m.optimizer.init(m.params), m.scaler.init(device="cpu")
    before = (_clone(list(m.params.arenas)), _clone(o))
    tok, tgt = (torch.from_numpy(a).long() for a in _batch())
    _, g, fi, s = svag(m.params, s, tok, tgt)
    m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
    return (jbefore, jafter), before, (list(m.params.arenas), o, s, fi)


def test_skip_step_leaves_state_untouched(skipped):
    """Both packages skip: masters, moments, model arenas and the step
    count bitwise unchanged, the dynamic scale halved."""
    (jbefore, jafter), (p0, o0), (p1, o1, s1, fi) = skipped
    assert bool(fi) and bool(jafter[3])
    for a, b in zip(p1, p0):
        assert torch.equal(a, b)
    for b in range(2):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(o1["inner"][b][key], o0["inner"][b][key])
            np.testing.assert_array_equal(jafter[1]["inner"][b][key],
                                          jbefore[1]["inner"][b][key])
        assert torch.equal(o1["master"][b], o0["master"][b])
        np.testing.assert_array_equal(jafter[1]["master"][b],
                                      jbefore[1]["master"][b])
        np.testing.assert_array_equal(_f32(jafter[0][b]), _f32(jbefore[0][b]))
    assert int(o1["inner"][0]["step"]) == 0
    assert s1["scale"].item() == 2.0 ** 15 == jafter[2]["scale"].item()
    assert s1["consecutive_overflows"].item() == 1
    assert s1["unskipped"].item() == 0 == jafter[2]["unskipped"].item()


def test_grads_born_flat_in_the_arena():
    """Every per-layer leaf of a stacked weight is a view of the gradient
    arena, so backward writes the arena itself."""
    cfg = tgpt.GPTConfig(**{**SMALL, "vocab_size": 64, "seq_len": 8,
                            "d_model": 16, "n_heads": 2})
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    packed = PackedParams.pack(params)
    grads = packed.zeros_like()
    tree = packed.grad_leaves(grads).unpack()
    wqkv = tree["blocks"]["wqkv"]
    assert isinstance(wqkv, tuple) and len(wqkv) == cfg.n_layers
    tok = torch.randint(0, 64, (2, 8), generator=torch.Generator().manual_seed(1))
    tgpt.loss_fn(tree, tok, torch.roll(tok, -1, -1), cfg).backward()
    ref_params = {k: (v.clone().requires_grad_(True) if k != "blocks" else
                      {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()})
                  for k, v in params.items()}
    tgpt.loss_fn(ref_params, tok, torch.roll(tok, -1, -1), cfg).backward()
    unpacked = PackedParams(grads.arenas, packed.layout).unpack()
    for k in ("wqkv", "ln1_scale", "wo2"):
        torch.testing.assert_close(unpacked["blocks"][k],
                                   ref_params["blocks"][k].grad)
    torch.testing.assert_close(unpacked["tok_embed"],
                               ref_params["tok_embed"].grad)
    for layer in wqkv:
        assert layer.grad.untyped_storage().data_ptr() == \
            grads.arenas[0].untyped_storage().data_ptr()
