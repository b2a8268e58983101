"""Port parity: the amp O5, arena-native FusedAdam training step of the MoE
GPT (``moe_every=2``, 4 experts, top-2, capacity factor 1.25; 4 layers of
width 32, seq 16, batch 2), held against the JAX package's step for three
steps, as ``tests/test_torch_training.py`` holds the dense step.

The objective is ``loss_and_aux``'s: the cross entropy plus the weighted
router losses, through the amp-wrapped apply on both sides. The JAX side
runs eagerly (bf16 rounded where PyTorch rounds it), its flash attention
on its jnp path (the Pallas kernel tiles 128 rows; seq is 16), its unscale
and Adam kernels in interpret mode; the port runs the kernels' plain
versions. The router weights are drawn at the model's std times
sqrt(1024 / 32), so that the logits spread as at the flagship's width (d
1024): at d 32 and std 0.02 the top-2 margins of a few tokens sit within
the bf16 noise between the two frameworks, and a choice that flips moves
that token's expert gradients past the dense step's bounds, which is the
argmax's discontinuity, not a fault.
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
from beforeholiday_tpu_torch.monitor.metrics import TrainMonitor
from beforeholiday_tpu_torch.optimizers import FusedAdam as TFusedAdam
from beforeholiday_tpu_torch.testing import gpt as tgpt

SMALL = dict(vocab_size=128, seq_len=16, d_model=32, n_heads=2, n_layers=4,
             moe_every=2, moe_experts=4)
LR = 1e-3
STEPS = 3
BF16_ULP = 2.0 ** -7
# the dense bf16 step's bounds (tests/test_torch_training.py)
TOL = dict(loss=1e-3, grad_atol=(2e-3, 1e-2), grad_rtol=BF16_ULP, master=3 * LR,
           sq_atol=1e-5)


def _batch():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, SMALL["vocab_size"], (2, SMALL["seq_len"]))
    return tok.astype(np.int32), np.roll(tok, -1, axis=-1).astype(np.int32)


def _jax_run():
    cfg = jgpt.GPTConfig(**SMALL, dtype=jnp.bfloat16)
    params = jgpt.init(jax.random.PRNGKey(0), cfg)
    params["moe"]["w_router"] = params["moe"]["w_router"] * np.sqrt(1024 / 32)
    m = jamp.initialize(lambda p, tok, tgt: jgpt.loss_and_aux(p, tok, tgt, cfg),
                        params, JFusedAdam(lr=LR, impl="pallas"), "O5",
                        arena_native=True)
    svag = jamp.scaled_value_and_grad(lambda p, tok, tgt: m.apply(p, tok, tgt)[0],
                                      m.scaler, impl="pallas")
    p, o, s = m.params, m.optimizer.init(m.params), m.scaler.init()
    tok, tgt = (jnp.asarray(a) for a in _batch())
    start = jax.tree.map(np.asarray, p.arenas)
    out = []
    for _ in range(STEPS):  # eager, as the port runs
        loss, g, fi, s = svag(p, s, tok, tgt)
        p, o = m.optimizer.step(p, g, o, found_inf=fi)
        out.append(jax.tree.map(np.asarray, dict(
            loss=loss, grads=g.arenas, found_inf=fi, model=p.arenas, opt=o, scaler=s)))
    return jax.tree.map(np.asarray, params), start, out


def _port_run(np_params):
    cfg = tgpt.GPTConfig(**SMALL, dtype=torch.bfloat16)
    params = tgpt.params_from_numpy(np_params, device="cpu")
    m = tamp.initialize(lambda p, tok, tgt: tgpt.loss_and_aux(p, tok, tgt, cfg),
                        params, TFusedAdam(lr=LR), "O5", arena_native=True)
    seen = {}

    def objective(p, tok, tgt):
        loss, seen["aux"] = m.apply(p, tok, tgt)
        return loss

    svag = tamp.scaled_value_and_grad(objective, m.scaler)
    o, s = m.optimizer.init(m.params), m.scaler.init(device="cpu")
    tok, tgt = (torch.from_numpy(a).long() for a in _batch())
    mon = TrainMonitor()
    out = []
    for _ in range(STEPS):
        loss, g, fi, s = svag(m.params, s, tok, tgt)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        metrics = mon.unpack_host(mon.pack(mon.update(
            mon.init(device="cpu"), loss=loss.detach(), moe={k: v.detach() for k, v in
                                                 seen["aux"].items()})))
        out.append(dict(loss=loss, grads=g.arenas, found_inf=fi,
                        model=[a.clone() for a in m.params.arenas],
                        master=[a.clone() for a in o["master"]],
                        inner=[{k: v.clone() for k, v in b.items()} for b in o["inner"]],
                        scaler=dict(s), metrics=metrics))
    return m, out


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _f32(a):
    return np.asarray(a, dtype=np.float32)


@pytest.fixture(scope="module")
def runs():
    np_params, start, jout = _jax_run()
    m, tout = _port_run(np_params)
    return np_params, start, jout, m, tout


def test_packed_layout_matches_jax(runs):
    """The ``moe`` subtree packs in tree order: the same buckets, offsets
    and padding, and the model arenas at init the same casts, bit for
    bit."""
    np_params, start, _, _, _ = runs
    fresh = tamp.initialize(lambda p, t: p, tgpt.params_from_numpy(np_params, device="cpu"),
                            TFusedAdam(lr=LR), "O5", arena_native=True).params
    assert [a.dtype for a in fresh.arenas] == [torch.bfloat16, torch.float32]
    for got, ref in zip(fresh.arenas, start):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(_np(got), _f32(ref))


@pytest.mark.parametrize("step", range(STEPS))
def test_moe_step_matches_jax(runs, step):
    """Loss, found_inf, grad arenas, masters, moments, model arenas, step
    count and scaler state after each of three steps, at the dense bf16
    step's bounds; the router's scalars reach ``TrainMonitor``."""
    _, _, jout, _, tout = runs
    g_atol = TOL["grad_atol"][min(step, 1)]
    j, t = jout[step], tout[step]
    np.testing.assert_allclose(t["loss"].item(), float(j["loss"]), rtol=TOL["loss"])
    assert bool(t["found_inf"]) == bool(j["found_inf"]) is False
    for got, ref in zip(t["grads"], j["grads"]):
        np.testing.assert_allclose(_np(got), _f32(ref), atol=g_atol,
                                   rtol=TOL["grad_rtol"])
    for b in range(2):
        jo, to = j["opt"]["inner"][b], t["inner"][b]
        assert int(to["step"]) == int(jo["step"]) == step + 1
        np.testing.assert_allclose(_np(t["master"][b]), _f32(j["opt"]["master"][b]),
                                   atol=TOL["master"] * (step + 1), rtol=0)
        np.testing.assert_allclose(_np(to["exp_avg"]), _f32(jo["exp_avg"]),
                                   atol=g_atol, rtol=TOL["grad_rtol"])
        np.testing.assert_allclose(_np(to["exp_avg_sq"]), _f32(jo["exp_avg_sq"]),
                                   atol=TOL["sq_atol"], rtol=2 * TOL["grad_rtol"])
        np.testing.assert_array_equal(_np(t["model"][b]),
                                      _np(t["master"][b].to(t["model"][b].dtype)))
    for key in ("scale", "unskipped", "consecutive_overflows"):
        assert t["scaler"][key].item() == j["scaler"][key].item()
    met = t["metrics"]
    assert met["loss"] == pytest.approx(t["loss"].item())
    assert met["moe_aux_loss"] > 0.0 and met["moe_z_loss"] > 0.0
    assert 0.0 <= met["moe_drop_fraction"] < 1.0


def test_loss_falls_and_dead_slots_stay(runs):
    """The loss falls on the fixed batch; the MoE layers' dense MLP slots
    get zero gradient, so their masters stay at their init."""
    np_params, _, _, m, tout = runs
    losses = [t["loss"].item() for t in tout]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    wi = m.params.unpack()["blocks"]["wi"]
    ref = torch.from_numpy(np.array(np_params["blocks"]["wi"])).to(wi.dtype)
    assert torch.equal(wi[1], ref[1]) and torch.equal(wi[3], ref[3])
    assert not torch.equal(wi[0], ref[0])
