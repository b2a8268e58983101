"""Port parity: amp — ``LossScaler`` (scale, unscale through kernel K5's
plain path, the update rule, checkpoints), ``initialize``'s opt-level
policies and overrides, ``make_apply`` and the tree path of
``scaled_value_and_grad`` with ``FusedAdam`` and ``MasterWeights``, held
against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import amp as jamp
from beforeholiday_tpu.optimizers import FusedAdam as JFusedAdam
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.amp import frontend as tfront
from beforeholiday_tpu_torch.amp import functional as tfunctional
from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten
from beforeholiday_tpu_torch.optimizers import FusedAdam as TFusedAdam
from beforeholiday_tpu_torch.optimizers import MasterWeights, supports_flat_step


def _jstate(s):
    return {k: np.asarray(v) for k, v in s.items()}


# ------------------------------------------------------------- LossScaler


SEQUENCES = {
    "overflow_then_grow": [True, False, False, False, True, False, False, False],
    "clean": [False] * 7,
    "floor": [True] * 6,
}


@pytest.mark.parametrize("seq", list(SEQUENCES))
@pytest.mark.parametrize("kw", [
    dict(loss_scale="dynamic", scale_window=3),
    dict(loss_scale="dynamic", scale_window=2, init_scale=8.0,
         min_loss_scale=2.0, max_loss_scale=16.0),
    dict(loss_scale=128.0),
])
def test_scaler_update_sequence_matches_jax(seq, kw):
    js, ts = jamp.LossScaler(**kw), tamp.LossScaler(**kw)
    jst, tst = js.init(), ts.init(device="cpu")
    for found in SEQUENCES[seq]:
        jst = js.update(jst, jnp.bool_(found))
        tst = ts.update(tst, torch.tensor(found))
        for key in ("scale", "unskipped", "consecutive_overflows"):
            assert tst[key].item() == np.asarray(jst[key]).item(), key
            assert tst[key].dtype == (torch.float32 if key == "scale" else torch.int32)
        assert bool(ts.at_min_scale(tst)) == bool(js.at_min_scale(jst))


@pytest.mark.parametrize("dtypes", [("float32",), ("bfloat16", "float32")])
def test_unscale_matches_jax(dtypes):
    """A grad tree with one K5 call per dtype: bitwise fp32 values and the
    OR of the flags."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5),
            "c": rng.standard_normal((2, 2))}
    names = dict(zip("abc", (dtypes * 3)[:3]))
    jtree = {k: jnp.asarray(v, names[k]) for k, v in tree.items()}
    ttree = {k: torch.from_numpy(np.array(jtree[k], np.float32)).to(
        getattr(torch, names[k])) for k in tree}
    js, ts = jamp.LossScaler(init_scale=1024.0), tamp.LossScaler(init_scale=1024.0)
    jg, jf = js.unscale(jtree, js.init())
    tg, tf = ts.unscale(ttree, ts.init(device="cpu"))
    assert bool(tf) == bool(jf) is False
    for k in tree:
        assert tg[k].dtype == torch.float32
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
    ttree["b"][2] = float("nan")
    assert bool(ts.unscale(ttree, ts.init(device="cpu"))[1])


def test_unscale_packed_grads_keeps_the_layout():
    grads = PackedParams.pack({"w": torch.ones(3, dtype=torch.bfloat16),
                               "ln": torch.ones(2)})
    ts = tamp.LossScaler(init_scale=4.0)
    out, found = ts.unscale(grads, ts.init(device="cpu"))
    assert isinstance(out, PackedParams) and out.layout == grads.layout
    assert [a.dtype for a in out.arenas] == [torch.float32, torch.float32]
    assert out.arenas[0][:3].eq(0.25).all() and not bool(found)


def test_scale_loss_and_checkpoint_roundtrip():
    ts = tamp.LossScaler()
    st = ts.init(device="cpu")
    assert ts.scale_loss(torch.tensor(2.0, dtype=torch.bfloat16), st).item() == 2.0 ** 17
    st = ts.update(st, torch.tensor(True))
    sd = ts.state_dict(st)
    js = jamp.LossScaler()
    assert sd == js.state_dict(js.update(js.init(), jnp.bool_(True)))
    back = ts.load_state_dict(sd, device="cpu")
    assert all(torch.equal(back[k], st[k]) for k in st)


# -------------------------------------------------------------- initialize


def _tree():
    rng = np.random.default_rng(1)
    return {
        "dense": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": rng.standard_normal(3).astype(np.float32)},
        "ln1_scale": np.ones(3, np.float32),
        "norm": {"bias": np.zeros(3, np.float32)},
        "bn1": np.ones(2, np.float32),
    }


def _dtypes_of(tree):
    return [str(x.dtype).replace("torch.", "") for x in tree_flatten(tree)[0]]


@pytest.mark.parametrize("level, kw", [
    ("O0", {}),
    ("O5", {}),
    ("O5", dict(keep_batchnorm_fp32=False)),
    ("O5", dict(master_weights=False)),
    ("O5", dict(loss_scale="dynamic")),
    ("O0", dict(loss_scale=64.0)),
    ("O1", {}),
    ("O2", {}),
    ("O3", {}),
    ("O4", {}),
    ("O1", dict(loss_scale=128.0)),
    ("O2", dict(keep_batchnorm_fp32=False)),
    ("O2", dict(master_weights=False, loss_scale=1024.0)),
    ("O3", dict(keep_batchnorm_fp32=True)),
    ("O4", dict(loss_scale="dynamic")),
])
def test_initialize_policy_matches_jax(level, kw):
    tree = _tree()
    jm = jamp.initialize(lambda p, x: x, jax.tree.map(jnp.asarray, tree),
                         JFusedAdam(), level, **kw)
    tm = tamp.initialize(lambda p, x: x, jax.tree.map(torch.from_numpy, tree),
                         TFusedAdam(), level, **kw)
    assert _dtypes_of(tm.params) == [
        x.dtype.name for x in jax.tree_util.tree_leaves(jm.params)]
    assert isinstance(tm.optimizer, MasterWeights) == isinstance(
        jm.optimizer, jamp.MasterWeights)
    assert tm.scaler.loss_scale == jm.scaler.loss_scale
    for f in ("opt_level", "keep_batchnorm_fp32", "master_weights", "loss_scale"):
        assert getattr(tm.policy, f) == getattr(jm.policy, f)


def test_initialize_rejects_what_jax_rejects(tmp_path):
    with pytest.raises(RuntimeError):
        tamp.initialize(lambda p, x: x, {"w": torch.zeros(2)}, None, "O9")
    # tuned=True is no refusal since the autotuner's port: a manifest miss
    # keeps O5 in both packages (tests/test_torch_tune.py holds the hits)
    missing = str(tmp_path / "missing.json")
    tm = tamp.initialize(lambda p, x: x, {"w": torch.zeros(2)}, None, tuned=True,
                         tuning_manifest=missing)
    jm = jamp.initialize(lambda p, x: x, {"w": jnp.zeros(2)}, JFusedAdam(), tuned=True,
                         tuning_manifest=missing)
    assert tm.policy.opt_level == jm.policy.opt_level == "O5"
    with pytest.raises(ValueError, match="arena_native"):
        tamp.initialize(lambda p, x: x, {"w": torch.zeros(2)}, TFusedAdam(),
                        "O5", master_weights=False, arena_native=True)
    for level in ("O1", "O4"):  # JAX refuses arena_native with a scope
        with pytest.raises(ValueError, match="arena_native"):
            jamp.initialize(lambda p, x: x, {"w": jnp.zeros(2)}, JFusedAdam(),
                            level, arena_native=True)
        with pytest.raises(ValueError, match="arena_native"):
            tamp.initialize(lambda p, x: x, {"w": torch.zeros(2)}, TFusedAdam(),
                            level, arena_native=True)
    with pytest.raises(ValueError):
        tamp.initialize(lambda p, x: x, {"w": torch.zeros(2)}, None, "O5",
                        num_losses=0)


def test_default_keep_fp32_matches_jax():
    for name in ("ln1_scale", "lnf_bias", "layernorm", "bn2", "sync_bn", "norm",
                 "wqkv", "tok_embed", "bias", "blnk"):
        jpath = (jax.tree_util.DictKey(name),)
        assert tfront._default_keep_fp32((name,)) == jamp.frontend._default_keep_fp32(jpath)


def test_opt_levels_match_jax():
    for name, jp in jamp.opt_levels.items():
        tp = tamp.opt_levels[name]
        for f in ("opt_level", "patch_torch_functions", "keep_batchnorm_fp32",
                  "master_weights", "loss_scale", "quantized"):
            assert getattr(tp, f) == getattr(jp, f), (name, f)
        assert str(tp.compute_dtype).replace("torch.", "") == jnp.dtype(
            jp.compute_dtype).name


def test_make_apply_casts_inputs_and_outputs():
    seen = {}

    def apply_fn(p, x, idx):
        seen.update(x=x.dtype, idx=idx.dtype)
        return {"y": x * 2, "n": idx}

    m = tamp.initialize(apply_fn, {"w": torch.zeros(2)}, None, "O5",
                        arena_native=True)
    out = m.apply(m.params, torch.ones(2), torch.arange(2))
    assert seen == dict(x=torch.bfloat16, idx=torch.int64)
    assert out["y"].dtype == torch.float32 and out["n"].dtype == torch.int64


def test_state_dict_per_loss():
    m = tamp.initialize(lambda p, x: x, {"w": torch.zeros(2)}, None, "O5",
                        loss_scale="dynamic", num_losses=2)
    states = [s.init(device="cpu") for s in m.scalers]
    sd = m.state_dict(states)
    assert set(sd) == {"loss_scaler0", "loss_scaler1"}
    with pytest.raises(ValueError):
        m.state_dict(states[0])
    back = m.load_state_dict(sd, device="cpu")
    assert len(back) == 2 and back[1]["scale"].item() == 2.0 ** 16


def test_tags_and_functional():
    assert tamp.float_function(lambda x: x).__amp_list__ == "float"
    assert tamp.half_function(lambda x: x).__amp_list__ == "half"
    logits = torch.randn(4, 7, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([0, 3, 6, 1])
    torch.testing.assert_close(tfunctional.cross_entropy(logits, labels),
                               torch.nn.functional.cross_entropy(logits, labels))
    assert supports_flat_step(TFusedAdam())
    assert not supports_flat_step(TFusedAdam(no_weight_decay_mask=lambda p: True))


# ---------------------------------------- the tree path (no arenas), 3 steps


def _mlp_loss(p, x, y, tanh):
    h = tanh(x @ p["w1"] + p["b1"])
    return ((h @ p["w2"] - y) ** 2).mean()


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4", "O5"])
def test_tree_training_matches_jax(level):
    """``scaled_value_and_grad`` on a plain params tree, then FusedAdam
    (O0, O1, O3, O4: on the fp32 tree, O3's fp16 one) or
    MasterWeights(FusedAdam) (O2, O5), three steps with a dynamic scale and
    decoupled weight decay. O1 and O4 cast the fp32 params at each call."""
    rng = np.random.default_rng(2)
    tree = {"w1": rng.standard_normal((8, 16)) * 0.3, "b1": np.zeros(16),
            "w2": rng.standard_normal((16, 4)) * 0.3}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = rng.standard_normal((32, 4)).astype(np.float32)

    def jloss(p, x, y):
        return _mlp_loss({k: v.astype(jnp.float32) for k, v in p.items()},
                         x.astype(jnp.float32), y.astype(jnp.float32), jnp.tanh)

    def tloss(p, x, y):
        return _mlp_loss({k: v.float() for k, v in p.items()}, x.float(),
                         y.float(), torch.tanh)

    jm = jamp.initialize(jloss, jax.tree.map(jnp.asarray, tree),
                         JFusedAdam(lr=1e-2, weight_decay=0.1), level,
                         loss_scale="dynamic")
    tm = tamp.initialize(tloss, {k: torch.from_numpy(v) for k, v in tree.items()},
                         TFusedAdam(lr=1e-2, weight_decay=0.1), level,
                         loss_scale="dynamic")
    jsvag = jamp.scaled_value_and_grad(lambda p, a, b: jm.apply(p, a, b), jm.scaler)
    tsvag = tamp.scaled_value_and_grad(lambda p, a, b: tm.apply(p, a, b), tm.scaler)
    jp, jo, js = jm.params, jm.optimizer.init(jm.params), jm.scaler.init()
    tp, to, ts = tm.params, tm.optimizer.init(tm.params), tm.scaler.init(device="cpu")
    # fp32 compute over params rounded to the storage or compute dtype
    tol = {"O0": dict(rtol=1e-5, atol=1e-6), "O4": dict(rtol=2 ** -7, atol=1e-3),
           "O5": dict(rtol=2 ** -7, atol=1e-3)}.get(level, dict(rtol=2 ** -10, atol=1e-3))
    for _ in range(3):
        jl, jg, jf, js = jsvag(jp, js, jnp.asarray(x), jnp.asarray(y))
        jp, jo = jm.optimizer.step(jp, jg, jo, found_inf=jf)
        tl, tg, tf, ts = tsvag(tp, ts, torch.from_numpy(x), torch.from_numpy(y))
        tp, to = tm.optimizer.step(tp, tg, to, found_inf=tf)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        assert bool(tf) == bool(jf) is False
        for k in tree:
            assert tp[k].dtype == getattr(torch, jp[k].dtype.name)
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **tol)
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       np.asarray(jp[k], np.float32), **tol)
        assert _jstate(js)["scale"] == ts["scale"].item()


def test_masks_match_jax():
    """``keep_fp32_mask`` picks the fp32 leaves; the list step's
    ``no_weight_decay_mask`` exempts leaves from decay, as in JAX."""
    tree = _tree()

    def keep(path):
        return "w" in [str(getattr(p, "key", p)) for p in path]

    def no_decay(path):
        return str(getattr(path[-1], "key", path[-1])) == "b"

    jm = jamp.initialize(lambda p, x: x, jax.tree.map(jnp.asarray, tree), None,
                         "O5", keep_fp32_mask=keep)
    tm = tamp.initialize(lambda p, x: x, jax.tree.map(torch.from_numpy, tree),
                         None, "O5", keep_fp32_mask=keep)
    assert _dtypes_of(tm.params) == [
        x.dtype.name for x in jax.tree_util.tree_leaves(jm.params)]
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         tree)
    jo = JFusedAdam(lr=1e-2, weight_decay=0.5, no_weight_decay_mask=no_decay)
    to = TFusedAdam(lr=1e-2, weight_decay=0.5, no_weight_decay_mask=no_decay)
    jp, js = jax.tree.map(jnp.asarray, tree), None
    tp = jax.tree.map(torch.from_numpy, tree)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):
        jp, js = jo.step(jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts = to.step(tp, jax.tree.map(torch.from_numpy, grads), ts)
    for a, b in zip(tree_flatten(tp)[0], jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 2
