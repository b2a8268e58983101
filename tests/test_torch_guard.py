"""Port parity: ``guard.StepGuard`` and ``testing.faults`` against the JAX
package's, on the scenarios of ``tests/test_guard.py`` (the same numpy
inputs through both): a clean step, a NaN loss skipping with the params and
momentum bitwise unchanged and the scale halved, a gradient overflow under a
finite loss, the parameter sentinel reverting params and optimizer state,
rollback after two consecutive overflows at the scaler's floor, the snapshot
following clean steps only, the state dict (and the ``health{i}`` entry of
``amp.AmpModel.state_dict``), the guard on the arena-native O5 path (the
optimizer updating in place), and ``poison_grads`` hitting the same
elements. Tolerances are in PERF.md: the skip reasons, health counters and
skipped states are held exactly; a clean SGD step at rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.amp.scaler import LossScaler as JScaler
from beforeholiday_tpu.guard import StepGuard as JGuard
from beforeholiday_tpu.optimizers import FusedSGD as JSGD
from beforeholiday_tpu.testing import faults as jfaults
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.amp.scaler import LossScaler as TScaler
from beforeholiday_tpu_torch.guard import (
    SKIP_GRAD_OVERFLOW,
    SKIP_LOSS_NONFINITE,
    SKIP_PARAM_NONFINITE,
    SKIP_ROLLBACK,
    StepGuard as TGuard,
    health_summary,
)
from beforeholiday_tpu_torch.ops.arena import PackedParams
from beforeholiday_tpu_torch.optimizers import FusedSGD as TSGD
from beforeholiday_tpu_torch.testing import faults as tfaults

W0 = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
GOOD = np.array([1.0, -1.0, 0.5, 2.0], np.float32)
NAN_FIRST = np.array([np.nan, 1.0, 1.0, 1.0], np.float32)


def _jloss(p, x):
    return jnp.sum(p["w"] * x)


def _tloss(p, x):
    return (p["w"] * x).sum()


class _Pair:
    """The same guarded SGD setup in both packages."""

    def __init__(self, scaler_kw, **guard_kw):
        self.jp = {"w": jnp.asarray(W0)}
        self.jopt = JSGD(lr=0.1)
        self.jo = self.jopt.init(self.jp)
        self.jg = JGuard(JScaler(**scaler_kw), **guard_kw)
        self.jgs = self.jg.init(self.jp)
        self.tp = {"w": torch.tensor(W0)}
        self.topt = TSGD(lr=0.1)
        self.to = self.topt.init(self.tp)
        self.tg = TGuard(TScaler(**scaler_kw), **guard_kw)
        self.tgs = self.tg.init(self.tp)
        self.jvg = self.jg.value_and_grad(_jloss)
        self.tvg = self.tg.value_and_grad(_tloss)

    def step(self, x):
        loss, grads, verdict = self.jvg(self.jp, self.jgs, jnp.asarray(x))
        self.jp, self.jo, self.jgs = self.jg.apply_update(
            self.jopt, self.jp, grads, self.jo, self.jgs, verdict)
        tloss, tgrads, tverdict = self.tvg(self.tp, self.tgs, torch.tensor(x))
        self.tp, self.to, self.tgs = self.tg.apply_update(
            self.topt, self.tp, tgrads, self.to, self.tgs, tverdict)
        for k in verdict:
            assert bool(verdict[k]) == bool(tverdict[k]), k
        np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)

    def check(self, exact=False):
        jw, tw = np.asarray(self.jp["w"]), self.tp["w"].numpy()
        if exact:
            np.testing.assert_array_equal(tw, jw)
        else:
            np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
        jh = {k: int(v) for k, v in self.jgs["health"].items()}
        th = {k: int(v) for k, v in self.tgs["health"].items()}
        assert th == jh
        assert float(self.tgs["scaler"]["scale"]) == float(self.jgs["scaler"]["scale"])
        return th


def test_clean_step_matches_jax():
    pair = _Pair(dict(init_scale=4.0, min_loss_scale=1.0))
    pair.step(GOOD)
    h = pair.check()
    assert h["skipped_total"] == 0 and float(pair.tgs["scaler"]["scale"]) == 4.0


def test_nan_loss_skips_bitwise_and_halves_the_scale():
    pair = _Pair(dict(init_scale=4.0, min_loss_scale=1.0))
    mom = pair.to["momentum_buffer"]["w"].clone()
    pair.step(NAN_FIRST)
    h = pair.check(exact=True)
    np.testing.assert_array_equal(pair.tp["w"].numpy(), W0)
    assert torch.equal(pair.to["momentum_buffer"]["w"], mom)
    assert int(pair.to["step"]) == 0
    assert h["last_skip_reason"] == SKIP_LOSS_NONFINITE
    assert h["consecutive_overflows"] == 1
    assert float(pair.tgs["scaler"]["scale"]) == 2.0


def test_grad_overflow_reason_under_a_finite_loss():
    g = np.array([np.inf, 0.0, 0.0, 0.0], np.float32)
    jg = JGuard(JScaler(init_scale=2.0, min_loss_scale=1.0))
    tg = TGuard(TScaler(init_scale=2.0, min_loss_scale=1.0))
    jp, tp = {"w": jnp.asarray(W0)}, {"w": torch.tensor(W0)}
    jv = jg.check_grads(jnp.float32(1.25), {"w": jnp.asarray(g)})
    tv = tg.check_grads(torch.tensor(1.25), {"w": torch.tensor(g)})
    assert {k: bool(v) for k, v in tv.items()} == {k: bool(v) for k, v in jv.items()}
    jopt, topt = JSGD(lr=0.1), TSGD(lr=0.1)
    jp2, _, jgs = jg.apply_update(jopt, jp, {"w": jnp.asarray(g)}, jopt.init(jp),
                                  jg.init(jp), jv)
    tp2, _, tgs = tg.apply_update(topt, tp, {"w": torch.tensor(g)}, topt.init(tp),
                                  tg.init(tp), tv)
    np.testing.assert_array_equal(tp2["w"].numpy(), np.asarray(jp2["w"]))
    assert int(tgs["health"]["last_skip_reason"]) == SKIP_GRAD_OVERFLOW
    assert int(jgs["health"]["last_skip_reason"]) == SKIP_GRAD_OVERFLOW


class _TBlowup:
    """Finite grads, a non-finite update, in place as the port's optimizers
    update (the class of fault the gradient flag cannot see)."""

    def init(self, params):
        return {"calls": torch.zeros((), dtype=torch.int32)}

    def step(self, params, grads, state, *, found_inf=None, grad_scale=1.0):
        skip = torch.as_tensor(found_inf) != 0
        for p in params.values():
            torch.where(skip, p, p + float("inf"), out=p)
        state["calls"].add_(torch.where(skip, 0, 1).to(torch.int32))
        return params, state


class _JBlowup:
    def init(self, params):
        return {"calls": jnp.int32(0)}

    def step(self, params, grads, state, *, found_inf=None, grad_scale=1.0):
        skip = jnp.asarray(found_inf) != 0
        new = jax.tree_util.tree_map(lambda p: jnp.where(skip, p, p + jnp.inf),
                                     params)
        return new, {"calls": state["calls"] + jnp.where(skip, 0, 1)}


def test_param_sentinel_reverts_params_and_optimizer_state():
    kw = dict(init_scale=4.0, min_loss_scale=1.0)
    jg, tg = JGuard(JScaler(**kw), check_params=True), TGuard(TScaler(**kw), check_params=True)
    jp, tp = {"w": jnp.ones(4)}, {"w": torch.ones(4)}
    jl, jgr, jv = jg.value_and_grad(_jloss)(jp, jg.init(jp), jnp.ones(4))
    tl, tgr, tv = tg.value_and_grad(_tloss)(tp, tg.init(tp), torch.ones(4))
    jopt, topt = _JBlowup(), _TBlowup()
    jp2, jo2, jgs = jg.apply_update(jopt, jp, jgr, jopt.init(jp), jg.init(jp), jv)
    tp2, to2, tgs = tg.apply_update(topt, tp, tgr, topt.init(tp), tg.init(tp), tv)
    np.testing.assert_array_equal(tp2["w"].numpy(), np.asarray(jp2["w"]))
    np.testing.assert_array_equal(tp2["w"].numpy(), np.ones(4, np.float32))
    assert int(to2["calls"]) == int(jo2["calls"]) == 0
    assert int(tgs["health"]["last_skip_reason"]) == SKIP_PARAM_NONFINITE
    assert float(tgs["scaler"]["scale"]) == float(jgs["scaler"]["scale"]) == 2.0


def test_rollback_after_two_overflows_at_the_floor():
    pair = _Pair(dict(init_scale=2.0, min_loss_scale=1.0), rollback_after=2)
    pair.step(GOOD)
    clean = pair.tp["w"].clone()
    assert torch.equal(pair.tgs["snapshot"]["w"], clean)
    pair.step(NAN_FIRST)
    assert int(pair.check()["rollbacks_total"]) == 0
    pair.tp["w"].add_(1.0)  # a drift the rollback must undo
    pair.jp = {"w": pair.jp["w"] + 1.0}
    pair.step(NAN_FIRST)
    h = pair.check()
    assert torch.equal(pair.tp["w"], clean)
    assert h["rollbacks_total"] == 1 and h["last_skip_reason"] == SKIP_ROLLBACK
    assert h["consecutive_overflows"] == 0 and h["skipped_total"] == 2
    assert int(pair.tgs["scaler"]["consecutive_overflows"]) == 0
    assert health_summary(h)["last_skip_reason_name"] == "rollback"


def test_snapshot_follows_clean_steps_only():
    pair = _Pair(dict(init_scale=2.0, min_loss_scale=1.0), rollback_after=3)
    pair.step(np.ones(4, np.float32))
    after_clean = pair.tp["w"].clone()
    pair.step(np.full(4, np.nan, np.float32))
    assert torch.equal(pair.tgs["snapshot"]["w"], after_clean)
    pair.step(np.ones(4, np.float32))
    pair.check()
    assert torch.equal(pair.tgs["snapshot"]["w"], pair.tp["w"])


def test_state_dict_round_trip_and_old_checkpoints():
    pair = _Pair(dict(init_scale=8.0, min_loss_scale=1.0), rollback_after=2)
    pair.step(np.full(4, np.nan, np.float32))
    sd, jsd = pair.tg.state_dict(pair.tgs), pair.jg.state_dict(pair.jgs)
    assert sd["health"] == jsd["health"] and sd["loss_scale"] == jsd["loss_scale"] == 4.0
    restored = pair.tg.load_state_dict(sd, params=pair.tp, device="cpu")
    assert float(restored["scaler"]["scale"]) == 4.0
    assert int(restored["health"]["skipped_total"]) == 1
    assert torch.equal(restored["snapshot"]["w"], pair.tp["w"])
    old = pair.tg.load_state_dict({"loss_scale": 16.0, "unskipped": 7},
                                  params=pair.tp, device="cpu")
    assert float(old["scaler"]["scale"]) == 16.0
    assert all(int(v) == 0 for v in old["health"].values())
    with pytest.raises(ValueError, match="needs params"):
        pair.tg.load_state_dict(sd, device="cpu")
    with pytest.raises(ValueError):
        TGuard(rollback_after=-1)
    with pytest.raises(NotImplementedError):
        pair.tg.apply_sharded_update(None, None, None, None, None)


def test_amp_state_dict_carries_health():
    params = {"w": torch.ones(4, 4)}
    model = tamp.initialize(lambda p, x: x @ p["w"], params, TSGD(lr=0.1), "O5")
    guard = TGuard(model.scaler)
    gstate = guard.init(model.params)
    sd = model.state_dict(gstate)
    assert "loss_scaler0" in sd and sd["health0"]["skipped_total"] == 0
    restored = model.load_state_dict(sd, device="cpu")
    assert set(restored) == {"scaler", "health"}
    assert int(restored["health"]["skipped_total"]) == 0
    bare = model.state_dict(model.scaler.init(device="cpu"))
    assert "health0" not in bare
    assert "scale" in model.load_state_dict(bare, device="cpu")


def test_guard_on_the_arena_native_path():
    """O5 arena-native: the optimizer updates the masters, momentum and
    model arena in place; a poisoned step leaves all three bitwise
    unchanged (check_params copies them first), and a NaN step at the floor
    rolls the model arena back to the snapshot."""
    params = {"w": torch.linspace(-1, 1, 12).reshape(3, 4), "bn": torch.ones(4)}
    model = tamp.initialize(lambda p, x: (x @ p["w"]).sum() * p["bn"].sum(),
                            params, TSGD(lr=0.1, momentum=0.9), "O5",
                            arena_native=True)
    assert isinstance(model.params, PackedParams)
    guard = TGuard(TScaler(loss_scale=1.0), rollback_after=2, check_params=True)
    gstate = guard.init(model.params)
    ostate = model.optimizer.init(model.params)
    vg = guard.value_and_grad(lambda p, x: model.apply(p, x))

    def step(p, o, gs, x, poison=False):
        red = (lambda g: tfaults.poison_grads(g, seed=3)) if poison else None
        loss, grads, verdict = guard.value_and_grad(
            lambda q, y: model.apply(q, y), reduce_grads=red)(p, gs, x)
        return guard.apply_update(model.optimizer, p, grads, o, gs, verdict)

    x = torch.ones(2, 3)
    p, o, gs = step(model.params, ostate, gstate, x)
    snap = [a.clone() for a in p.arenas]
    before = ([a.clone() for a in p.arenas], [m.clone() for m in o["master"]],
              [b["momentum_buffer"].clone() for b in o["inner"]])
    p, o, gs = step(p, o, gs, x, poison=True)
    assert int(gs["health"]["last_skip_reason"]) == SKIP_GRAD_OVERFLOW
    for xs, ys in zip(before, ([a for a in p.arenas], list(o["master"]),
                               [b["momentum_buffer"] for b in o["inner"]])):
        assert all(torch.equal(a, b) for a, b in zip(xs, ys))
    p.arenas[0].add_(1.0)  # drift the model arena; rollback restores it
    p, o, gs = step(p, o, gs, torch.full((2, 3), float("nan")))
    assert int(gs["health"]["last_skip_reason"]) == SKIP_ROLLBACK
    assert all(torch.equal(a, b) for a, b in zip(p.arenas, snap))
    del vg


@pytest.mark.parametrize("n, whole", [(1, False), (2, False), (3, True)])
def test_poison_grads_hits_the_same_elements(n, whole):
    rng = np.random.default_rng(n)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "d": rng.standard_normal((2, 2)).astype(np.float32)},
            "e": rng.standard_normal(7).astype(np.float32)}
    j = jfaults.poison_grads(jax.tree.map(jnp.asarray, tree), n=n, seed=11,
                             whole_leaf=whole)
    t = tfaults.poison_grads(jax.tree.map(torch.tensor, tree), n=n, seed=11,
                             whole_leaf=whole)
    for a, b in zip(jax.tree.leaves(j), jax.tree.leaves(
            {"a": t["a"], "b": {"c": t["b"]["c"], "d": t["b"]["d"]}, "e": t["e"]})):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    bad = sum(int(np.isnan(np.asarray(a)).any()) for a in jax.tree.leaves(j))
    assert bad == n


def test_fault_injectors_outside_the_step():
    tick = tfaults.preempt_after(2, surviving_world=1)
    tick()
    with pytest.raises(tfaults.SimulatedPreemption) as e:
        tick()
    assert e.value.surviving_world == 1
    tick()  # once only
    with pytest.raises(ValueError):
        tfaults.preempt_after(0)
    with pytest.raises(ValueError):
        tfaults.poison_grads({"w": torch.zeros(2)}, n=-1)
