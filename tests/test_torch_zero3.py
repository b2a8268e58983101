"""Port parity: ZeRO-3 (``optimizers/zero3.py``), its sharded checkpoints,
``guard.StepGuard.apply_sharded_update``, the GPT's amp O5 step on ZeRO-2
and ZeRO-3, and the ``zero3_fully_sharded`` example, against the JAX
package and against the port's ZeRO-2.

A spawned gloo world of 4, then one of 2 (``tests/_torch_world.py``
``zero3_scenario``); the JAX side under ``shard_map`` on the host devices,
``impl="jnp"``.

* ZeRO-3 bitwise the port's ZeRO-2 at W 2 and 4 (the linear loss of
  ``tests/test_zero3.py``, whose cotangent is the rank's grads), for
  ``prefetch`` 0, 1 and 2 and the per-bucket ``overlap_backward`` step;
  ``regather`` bitwise ``keep`` with twice the ``zero3.gather_params``
  calls; against JAX's ``ZeRO3FusedAdam`` at JAX's ZeRO bound (rtol 1e-4,
  atol 1e-5);
* an overflow on one rank skips the step on every rank; an unscattered
  grad tree is refused;
* ``apply_sharded_update`` (a skip at the scaler's floor rolls the triplet
  back) against JAX's: masters at rtol 1e-4, atol 1e-5, scale and health
  equal;
* the state round trip; shards saved at W 4, resharded to 2 and to 1,
  bitwise; JAX-written shard files load into the port (and reshard)
  bitwise, and the port's files load into JAX bitwise; a missing shard, a
  corrupted shard and a missing manifest fail loudly;
* the GPT (vocab 128, seq 32, d_model 64, 4 heads, 2 layers) at amp O5 for
  3 ZeRO-2 steps at W 2, batch 2 a rank, against JAX's ZeRO-2 on JAX's
  jitted O5 grads at the GPT O5 bf16 row (loss rel 5e-3, grads rel L2 0.05,
  masters 2 lr a step + 1e-6); ZeRO-3's first step ("keep" and "regather")
  bitwise ZeRO-2's;
* the example at W 2.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu import amp as jamp  # noqa: E402
from beforeholiday_tpu import guard as jguard  # noqa: E402
from beforeholiday_tpu.amp.scaler import LossScaler as JLossScaler  # noqa: E402
from beforeholiday_tpu.optimizers import (  # noqa: E402
    DistributedFusedAdam as JZeroAdam,
    ZeRO3FusedAdam as JZeRO3,
    zero3 as jzero3,
)
from beforeholiday_tpu.testing import gpt as jgpt  # noqa: E402
from beforeholiday_tpu_torch.optimizers import zero3  # noqa: E402
from beforeholiday_tpu_torch.optimizers.distributed_fused import _shard_len  # noqa: E402

_shard_map = getattr(jax, "shard_map", None)
_CHECK_KW = "check_vma"
if _shard_map is None:
    from jax.experimental.shard_map import shard_map as _shard_map

    _CHECK_KW = "check_rep"


def shard_map(f, **kw):
    kw.setdefault(_CHECK_KW, False)
    return _shard_map(f, **kw)


SHAPES = {"a": (300, 200), "b": (37, 19), "c": (128,), "d": (5, 3, 7)}
BB = 16 * 1024  # several buckets a shard: the stripe plan splits "a"
ADAM = dict(lr=1e-2, weight_decay=0.02)
STATE = {"master": P("data"), "exp_avg": P("data"), "exp_avg_sq": P("data"),
         "step": P()}
SMALL = dict(vocab_size=128, seq_len=32, d_model=64, n_heads=4, n_layers=2)
GPT_BATCH, GPT_LR, GPT_STEPS = 4, 1e-3, 3
GUARD = dict(rollback_after=1, check_params=True)
SCALER = dict(init_scale=2.0, min_loss_scale=1.0)
GUARD_BAD = (False, True, False)  # the second step overflows at the floor


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(W, seed, n=2, inf_at=None):
    rng = np.random.RandomState(seed)
    seq = [{k: rng.randn(W, *s).astype(np.float32) for k, s in SHAPES.items()}
           for _ in range(n)]
    if inf_at is not None:
        seq[inf_at]["c"][1, 3] = np.inf
    return seq


def _z3(**kw):
    return dict(ADAM, bucket_bytes=BB, **kw)


def _cases(W, extra=None):
    params, g = _params(), _grads(W, 1)
    cases = {
        "keep_p1": dict(kind="z3", params=params, grads=g,
                        kw=_z3(prefetch=1, param_residency="keep"),
                        z2=dict(ADAM, bucket_bytes=BB)),
        "regather_p1": dict(kind="z3", params=params, grads=g,
                            kw=_z3(prefetch=1, param_residency="regather")),
        "keep_p0": dict(kind="z3", params=params, grads=g,
                        kw=_z3(prefetch=0, param_residency="keep")),
        "keep_p2": dict(kind="z3", params=params, grads=g,
                        kw=_z3(prefetch=2, param_residency="keep")),
        "overlap": dict(kind="z3", params=params, grads=g,
                        kw=_z3(prefetch=1, param_residency="keep",
                               overlap_backward=True)),
        "overflow": dict(kind="z3", params=params, grads=_grads(W, 2, inf_at=0),
                         kw=_z3(param_residency="keep")),
        "refuse": dict(kind="refuse", params=params, grads=g,
                       kw=_z3(param_residency="keep")),
    }
    cases.update(extra or {})
    return cases


def _jax_layout():
    return jzero3.layout_of({k: jnp.asarray(v) for k, v in _params().items()})


def _jax_z3_state(mesh, grads_seq, **kw):
    """JAX's ZeRO-3 over ``grads_seq`` (rank-stacked): the state, its
    shards stacked on the data axis."""
    opt = JZeRO3(impl="jnp", **kw)
    layout = _jax_layout()

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P("data")),
                       out_specs=STATE)
    def run(p, gs):
        state = opt.init(p)
        for g in gs:
            g = jax.tree.map(lambda v: v[0], g)
            gm = jax.grad(lambda m: sum(jnp.vdot(
                opt.gather_params(m, layout)[k].astype(jnp.float32), g[k])
                for k in g))(state["master"])
            state = opt.step(gm, state)
        return state

    p0 = {k: jnp.asarray(v) for k, v in _params().items()}
    return run(p0, [{k: jnp.asarray(v) for k, v in g.items()} for g in grads_seq])


def _arena_tree(arena):
    """The tree (sorted keys, as both packages flatten a dict) of an arena."""
    out, off = {}, 0
    for k in sorted(SHAPES):
        n = int(np.prod(SHAPES[k]))
        out[k] = np.asarray(arena)[off: off + n].reshape(SHAPES[k])
        off += n
    return out


def _mesh(W):
    return Mesh(np.asarray(jax.devices()[:W]), ("data",))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return tw.run_world(tw.zero3_scenario, 4, tmp_path_factory.mktemp("z3w4"),
                        _cases(4))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX ZeRO-3 state at W 2 after the steps, written by the JAX
    package's ``save_shard_files``."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    state = _jax_z3_state(_mesh(2), _grads(2, 1), **_z3(param_residency="keep"))
    layout = _jax_layout()
    shard = _shard_len(layout.spec.padded_total, 2)
    stacked = {k: np.asarray(state[k]).reshape(2, shard)
               for k in ("master", "exp_avg", "exp_avg_sq")}
    stacked["step"] = np.asarray(state["step"])
    jzero3.save_shard_files(d, jzero3.shards_from_stacked(stacked, 2),
                            jzero3.shard_manifest(layout, 2))
    return d, stacked


def _gpt_inputs():
    params = jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0),
                                                jgpt.GPTConfig(**SMALL)))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, SMALL["vocab_size"], (GPT_BATCH, SMALL["seq_len"]))
    return params, tok.astype(np.int32), np.roll(tok, -1, axis=-1).astype(np.int32)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, world4, jax_ckpt):
    # W 4's shards resharded to 2, and the JAX-written files, loaded by the port
    layout = zero3.layout_of(tw._ttree(_params()))
    locals4 = [world4[r]["keep_p1"]["local"] for r in range(4)]
    re2 = zero3.reshard_state(locals4, zero3.shard_manifest(layout, 4), 2)
    mf, jshards = zero3.load_shard_files(jax_ckpt[0])
    extra = {
        "load_w4": dict(kind="load", params=_params(), shards=re2,
                        grads=_grads(2, 3), kw=_z3(param_residency="keep")),
        "load_jax": dict(kind="load", params=_params(), shards=jshards,
                         grads=_grads(2, 3), kw=_z3(param_residency="keep")),
        "guard": dict(kind="guard", params=_params(), grads=_grads(2, 4, n=3),
                      bad=GUARD_BAD, kw=_z3(param_residency="keep"), guard=GUARD,
                      scaler=SCALER),
        "gpt": dict(kind="gpt", args=(SMALL, *_gpt_inputs(), GPT_STEPS, GPT_LR)),
    }
    return tw.run_world(tw.zero3_scenario, 2, tmp_path_factory.mktemp("z3w2"),
                        _cases(2, extra))


def _worlds(world2, world4):
    return {2: world2, 4: world4}


@pytest.mark.parametrize("W", [2, 4])
def test_zero3_is_bitwise_zero2(world2, world4, W):
    for r, out in enumerate(_worlds(world2, world4)[W]):
        got = out["keep_p1"]
        assert got["steps"] == [1, 2]
        np.testing.assert_array_equal(got["master"], got["z2_master"])
        for k in SHAPES:
            np.testing.assert_array_equal(got["params"][k], got["z2_params"][k])


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case", ["keep_p0", "keep_p2", "overlap", "regather_p1"])
def test_prefetch_overlap_and_regather_are_bitwise(world2, world4, W, case):
    for out in _worlds(world2, world4)[W]:
        np.testing.assert_array_equal(out[case]["master"], out["keep_p1"]["master"])
        np.testing.assert_array_equal(out[case]["exp_avg"], out["keep_p1"]["exp_avg"])


@pytest.mark.parametrize("W", [2, 4])
def test_regather_doubles_the_gather_calls(world2, world4, W):
    for out in _worlds(world2, world4)[W]:
        keep, again = out["keep_p1"]["calls"], out["regather_p1"]["calls"]
        assert keep["zero3.gather_params"] > 0
        assert again["zero3.gather_params"] == 2 * keep["zero3.gather_params"]
        assert again["zero3.reduce_scatter_grads"] == keep["zero3.reduce_scatter_grads"]
        assert again["zero3.found_inf"] == keep["zero3.found_inf"] == 2


@pytest.mark.parametrize("W", [2, 4])
def test_zero3_matches_jax(world2, world4, W):
    state = _jax_z3_state(_mesh(W), _grads(W, 1), **_z3(param_residency="keep"))
    ref = _arena_tree(state["master"])
    for out in _worlds(world2, world4)[W]:
        for k in SHAPES:
            np.testing.assert_allclose(out["keep_p1"]["gathered"][k], ref[k],
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("W", [2, 4])
def test_overflow_on_one_rank_skips_everywhere(world2, world4, W):
    outs = _worlds(world2, world4)[W]
    for out in outs:
        assert out["overflow"]["steps"] == [0, 1]
    # every rank took the one clean step from the same masters
    for out in outs[1:]:
        np.testing.assert_array_equal(out["overflow"]["gathered"]["a"],
                                      outs[0]["overflow"]["gathered"]["a"])


def test_unscattered_grads_are_refused(world2):
    for out in world2:
        assert "reduce-scattered grad shard" in out["refuse"]


def test_apply_sharded_update_matches_jax(world2):
    mesh, layout = _mesh(2), _jax_layout()
    opt = JZeRO3(impl="jnp", **_z3(param_residency="keep"))
    guard = jguard.StepGuard(JLossScaler(**SCALER), **GUARD)
    gs = [{k: jnp.asarray(v) for k, v in g.items()} for g in _grads(2, 4, n=3)]

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P("data")), out_specs=P())
    def run(p, gs):
        state = opt.init(p)
        gstate = guard.init(state)
        for g, bad in zip(gs, GUARD_BAD):
            g = jax.tree.map(lambda v: v[0], g)
            gm = jax.grad(lambda m: sum(jnp.vdot(
                opt.gather_params(m, layout)[k].astype(jnp.float32), g[k])
                for k in g))(state["master"])
            verdict = {"grad_overflow": jnp.bool_(bad), "loss_nonfinite": jnp.bool_(False)}
            state, gstate = guard.apply_sharded_update(opt, state, gm, gstate, verdict)
        return (opt.state_dict(layout, state)["master"], state["step"],
                gstate["scaler"]["scale"], gstate["health"])

    master, step, scale, health = run({k: jnp.asarray(v) for k, v in _params().items()}, gs)
    assert {k: int(v) for k, v in health.items()}["rollbacks_total"] == 1
    for out in world2:
        got = out["guard"]
        assert got["step"] == int(step)
        assert got["scale"] == float(scale)
        assert got["health"] == {k: int(v) for k, v in health.items()}
        for k in SHAPES:
            np.testing.assert_allclose(got["master"][k], np.asarray(master[k]),
                                       rtol=1e-4, atol=1e-5)


def test_state_round_trip_and_reshard_bitwise(world2, world4):
    for out in world2 + world4:
        assert out["keep_p1"]["roundtrip_bitwise"]
    layout = zero3.layout_of(tw._ttree(_params()))
    mf4 = zero3.shard_manifest(layout, 4)
    locals4 = [world4[r]["keep_p1"]["local"] for r in range(4)]
    full = {k: np.concatenate([s[k] for s in locals4])[: mf4["arena_len"]]
            for k in mf4["state_keys"]}
    for new_world in (2, 1):
        re = zero3.reshard_state(locals4, mf4, new_world)
        assert len(re) == new_world
        for k in mf4["state_keys"]:
            assert re[0][k].shape == (_shard_len(mf4["arena_len"], new_world),)
            np.testing.assert_array_equal(
                np.concatenate([r[k] for r in re])[: mf4["arena_len"]], full[k])
    # the resharded state adopted at W 2 gathers to W 4's masters, bitwise
    for out in world2:
        for k in SHAPES:
            np.testing.assert_array_equal(out["load_w4"]["gathered"][k],
                                          world4[0]["keep_p1"]["gathered"][k])
        assert out["load_w4"]["step"] == 3


def test_jax_shard_files_load_into_the_port(world2, jax_ckpt):
    d, stacked = jax_ckpt
    mf, shards = zero3.load_shard_files(d)
    layout = zero3.layout_of(tw._ttree(_params()))
    assert mf == zero3.shard_manifest(layout, 2)
    ref = _arena_tree(stacked["master"].reshape(-1))
    for out in world2:
        for k in SHAPES:
            np.testing.assert_array_equal(out["load_jax"]["gathered"][k], ref[k])
        assert out["load_jax"]["step"] == 3
    re1 = zero3.reshard_state(shards, mf, 1)
    np.testing.assert_array_equal(re1[0]["master"][: mf["arena_len"]],
                                  stacked["master"].reshape(-1)[: mf["arena_len"]])


def test_port_shard_files_load_into_jax(world4, tmp_path):
    layout = zero3.layout_of(tw._ttree(_params()))
    zero3.save_shard_files(str(tmp_path), [world4[r]["keep_p1"]["local"] for r in range(4)],
                           zero3.shard_manifest(layout, 4))
    mf, shards = jzero3.load_shard_files(str(tmp_path))
    re = jzero3.reshard_state(shards, mf, 2)
    opt = JZeRO3(impl="jnp", **_z3(param_residency="keep"))
    jlayout = _jax_layout()
    stacked = {k: jnp.asarray(np.stack([r[k] for r in re]).reshape(-1))
               for k in ("master", "exp_avg", "exp_avg_sq")}
    stacked["step"] = jnp.asarray(re[0]["step"])

    @jax.jit
    @functools.partial(shard_map, mesh=_mesh(2), in_specs=(STATE,), out_specs=P())
    def adopt(st):
        local = {k: st[k] for k in STATE}
        return opt.state_dict(jlayout, opt.load_state_dict(jlayout, local))["master"]

    got = adopt(stacked)
    for k in SHAPES:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      world4[0]["keep_p1"]["gathered"][k])


def test_broken_checkpoints_fail_loudly(world4, tmp_path):
    layout = zero3.layout_of(tw._ttree(_params()))
    locals4 = [world4[r]["keep_p1"]["local"] for r in range(4)]
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        zero3.load_shard_files(str(tmp_path))
    zero3.save_shard_files(str(tmp_path), locals4, zero3.shard_manifest(layout, 4))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    os.remove(tmp_path / "shard_00003.npz")
    with pytest.raises(FileNotFoundError, match="shard_00003"):
        zero3.load_shard_files(str(tmp_path))
    zero3.save_shard_files(str(tmp_path), locals4, zero3.shard_manifest(layout, 4))
    with np.load(tmp_path / "shard_00002.npz") as z:
        d = {k: z[k] for k in z.files}
    d["exp_avg"] = d["exp_avg"][:-5]  # a truncated tensor
    np.savez(tmp_path / "shard_00002.npz", **d)
    with pytest.raises(ValueError, match="corrupted or mismatched"):
        zero3.load_shard_files(str(tmp_path))


def _jax_gpt_zero2():
    """JAX's ZeRO-2 (``DistributedFusedAdam``) at W 2 on the GPT's O5 cast
    params, each rank's grads from JAX's O5 loss on its half batch (jitted:
    XLA drops some bf16 roundings eager JAX and the port keep, inside the
    row's bounds)."""
    np_params, tok, tgt = _gpt_inputs()
    cfg = jgpt.GPTConfig(**SMALL, dtype=jnp.bfloat16)
    m = jamp.initialize(lambda p, t: jgpt.forward(p, t, cfg),
                        jax.tree.map(jnp.asarray, np_params), None, "O5")
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, y: jgpt.loss_fn(p, t, y, cfg, forward_fn=m.apply)))
    opt = JZeroAdam(lr=GPT_LR, impl="jnp")
    mesh = _mesh(2)
    init = jax.jit(shard_map(opt.init, mesh=mesh, in_specs=P(), out_specs=STATE))
    step = jax.jit(shard_map(
        lambda p, g, s: opt.step(p, jax.tree.map(lambda v: v[0], g), s),
        mesh=mesh, in_specs=(P(), P("data"), STATE), out_specs=(P(), STATE)))
    masters = jax.jit(shard_map(lambda p, s: opt.state_dict(p, s)["master"],
                                mesh=mesh, in_specs=(P(), STATE), out_specs=P()))
    p, s, out = m.params, init(m.params), []
    B = GPT_BATCH // 2
    for _ in range(GPT_STEPS):
        res = [vg(p, jnp.asarray(tok[r * B:(r + 1) * B]), jnp.asarray(tgt[r * B:(r + 1) * B]))
               for r in range(2)]
        g = jax.tree.map(lambda *x: jnp.stack(x), *[gr for _, gr in res])
        p, s = step(p, g, s)
        out.append(dict(losses=[float(l) for l, _ in res],
                        grads=[jax.tree.map(lambda a: np.asarray(a, np.float32), gr)
                               for _, gr in res],
                        masters=jax.tree.map(np.asarray, masters(p, s))))
    return out


def _leaves(tree):
    return [np.asarray(x, np.float32).reshape(-1) for x in jax.tree_util.tree_leaves(tree)]


def test_gpt_o5_zero2_matches_jax_and_zero3_is_bitwise(world2):
    ref = _jax_gpt_zero2()
    for r, out in enumerate(world2):
        got = out["gpt"]
        assert got["zero3_keep_bitwise"] and got["zero3_regather_bitwise"]
        for i, (g, j) in enumerate(zip(got["steps"], ref)):
            assert g["found_inf"] is False
            assert abs(g["loss"] - j["losses"][r]) <= 5e-3 * abs(j["losses"][r])
            a = np.concatenate(_leaves(g["grads"]))
            b = np.concatenate(_leaves(j["grads"][r]))
            assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b)
            for x, y in zip(_leaves(g["masters"]), _leaves(j["masters"])):
                np.testing.assert_allclose(x, y, rtol=0,
                                           atol=2 * GPT_LR * (i + 1) + 1e-6)


def test_constructor_refusals_and_amp_checkpoint_hooks():
    from beforeholiday_tpu_torch import amp as tamp
    from beforeholiday_tpu_torch.monitor import TrainMonitor
    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam, ZeRO3FusedLAMB

    with pytest.raises(ValueError, match="prefetch"):
        ZeRO3FusedAdam(prefetch=-1)
    with pytest.raises(ValueError, match="param_residency"):
        ZeRO3FusedAdam(param_residency="cached")
    with pytest.raises(NotImplementedError, match="trust"):
        ZeRO3FusedLAMB(lr=1e-3)
    assert ZeRO3FusedAdam(param_residency="keep").residency_policy() == "none"
    assert ZeRO3FusedAdam().residency_policy() == "zero3_regather"
    # AmpModel.state_dict's metrics and optimizer entries, as JAX's
    import torch

    params = {"w": torch.ones(4, 4)}
    m = tamp.initialize(lambda p, x: x @ p["w"], params, None, "O5")
    jm = jamp.initialize(lambda p, x: x @ p["w"], {"w": jnp.ones((4, 4))}, None, "O5")
    mon = TrainMonitor()
    metrics = mon.init(device="cpu")
    opt_sd = {"step": 3, "master": np.arange(4, dtype=np.float32)}
    sd = m.state_dict(m.scaler.init(device="cpu"), metrics=metrics,
                      optimizer_state=opt_sd)
    from beforeholiday_tpu.monitor import TrainMonitor as JTrainMonitor

    jsd = jm.state_dict(jm.scaler.init(), metrics=JTrainMonitor().init(),
                        optimizer_state=opt_sd)
    assert set(sd) == set(jsd) == {"loss_scaler0", "monitor", "optimizer"}
    assert sd["monitor"] == jsd["monitor"]
    assert m.load_optimizer_state(sd) is opt_sd and m.load_optimizer_state({}) is None
    back = m.load_metrics(sd, device="cpu")
    assert set(back) == set(metrics) and m.load_metrics({}) is None


def test_example_runs_at_world_2():
    from beforeholiday_tpu_torch.examples.simple.distributed import (
        zero3_fully_sharded as example,
    )

    res = example.main(["--device", "cpu", "--world", "2", "--steps", "3"])
    assert np.isfinite(res["loss"]) and res["resharded_to"] == 1
    assert res["shard"] * 2 >= 8 * 256 * 256
