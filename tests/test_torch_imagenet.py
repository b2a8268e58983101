"""Port parity: the ImageNet ResNet trainer (``examples/imagenet/main_amp.py``)
at amp O0 (the FusedSGD list path) and O5 (arena-native, fp32 masters), and
at O1-O4 (O2 arena-native with fp16 storage; O1/O4 fp32 storage cast at
every call inside the autocast scope; O3 fp16 storage on the list path),
held against the JAX trainer (``build_trainer(cfg=tiny_test_config(),
global_batch=16, num_classes=10, distributed=False)``) from the same initial
params and BN state on the same synthetic batches, the same with
FusedAdagrad, FusedNovoGrad, FusedLARS and LARC (the list path at both
levels), plus the amp ``has_state``/``has_aux`` pieces the trainer uses and
the options that are not ported.

Two comparisons (tolerances and measured values in PERF.md):

* free-running, three steps: each side from its own state. A ReLU whose
  input sits within rounding of 0 may take the other side in the two
  packages (XLA and PyTorch's native CPU convolutions round differently);
  at this size one such element moves a whole tensor's gradient by a few
  percent, so the momentum buffers, which are gradients, are held to a
  relative L2 bound there, and the loss, params and BN state (which one
  element moves by lr times as much) stay tight;
* one step from the JAX state before each step, loaded through the numpy
  loaders (namedtuples and the O5 arenas included): both sides start from
  the same bits, with the same tolerances.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples", "imagenet"))

import main_amp as jmain  # noqa: E402

from beforeholiday_tpu import amp as jamp  # noqa: E402
from beforeholiday_tpu import optimizers as jopt  # noqa: E402
from beforeholiday_tpu.models import resnet as jres  # noqa: E402
from beforeholiday_tpu_torch import amp as tamp  # noqa: E402
from beforeholiday_tpu_torch import optimizers as topt  # noqa: E402
from beforeholiday_tpu_torch.examples.imagenet import main_amp as tmain  # noqa: E402
from beforeholiday_tpu_torch.models import resnet as tres  # noqa: E402
from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten, tree_paths  # noqa: E402
from beforeholiday_tpu_torch.parallel import LARC  # noqa: E402

BATCH, HW, CLASSES, STEPS = 16, 16, 10, 3
LR = 0.1 * BATCH / 256
LEVELS = ("O0", "O5")
AMP_LEVELS = ("O1", "O2", "O3", "O4")
ARENA_LEVELS = ("O2", "O5")  # arena_native: PackedParams and fp32 masters


@pytest.fixture(autouse=True, scope="module")
def _native_cpu_convs():
    """PyTorch's CPU oneDNN convolution backward frees memory twice on a
    1x1 stride-2 channels-last convolution (ResNet's downsample) in the
    CPU build these tests run on; they take PyTorch's native CPU
    convolutions instead."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _batches(seed=7):
    return list(jmain.synthetic_batches(BATCH, HW, CLASSES, STEPS, seed=seed))


def _f32(a):
    return np.array(a, np.float32)


def _jax_run(level):
    """Three JAX trainer steps; each state as numpy, both raw (to load into
    the port) and as flat lists (to compare)."""
    tr = jmain.build_trainer(cfg=jres.tiny_test_config(), opt_level=level,
                             global_batch=BATCH, num_classes=CLASSES,
                             distributed=False, devices=jax.devices()[:1])

    def snap():
        raw = jax.tree.map(np.array, {
            "params": tr.params.arenas if level in ARENA_LEVELS else tr.params,
            "opt": tr.opt_state, "bn": tr.bn_state, "scaler": tr.scaler_state})
        inner = raw["opt"]["inner"] if level in ARENA_LEVELS else (raw["opt"],)
        return raw, {
            "params": [_f32(a) for a in jax.tree.leaves(raw["params"])],
            "mom": [_f32(a) for b in inner for a in jax.tree.leaves(b["momentum_buffer"])],
            "steps": [int(b["step"]) for b in inner],
            "bn": [_f32(a) for a in jax.tree.leaves(raw["bn"])],
            "masters": [_f32(a) for a in raw["opt"].get("master", ())]}

    raws, states, metrics = [], [], []
    for images, labels in [(None, None)] + _batches():
        if images is not None:
            m = tr.step(*tr.shard_batch(images, labels), LR)
            metrics.append({k: float(v) for k, v in m.items()})
        raw, state = snap()
        raws.append(raw)
        states.append(state)
    return raws, states, metrics


def _port_trainer(level, raw=None, *, seed=0, **kw):
    """The port's trainer from the JAX init (``build_trainer``'s
    ``seed``), or loaded with a JAX snapshot (``raw``)."""
    p, s = jres.init(jax.random.PRNGKey(seed), jres.tiny_test_config())
    p, s = jax.tree.map(np.asarray, (p, s))
    tr = tmain.build_trainer(
        cfg=tres.tiny_test_config(), opt_level=level, global_batch=BATCH,
        num_classes=CLASSES, params=tres.params_from_numpy(p, device="cpu"),
        bn_state=tres.state_from_numpy(s, device="cpu"), device="cpu", **kw)
    if raw is not None:
        if level in ARENA_LEVELS:
            for a, b in zip(tr.params.arenas, tres.state_from_numpy(
                    raw["params"], device="cpu")):
                a.copy_(b)
        else:
            tr.params = tres.params_from_numpy(raw["params"], device="cpu")
        tr.opt_state = tres.state_from_numpy(raw["opt"], device="cpu")
        tr.bn_state = tres.state_from_numpy(raw["bn"], device="cpu")
        tr.scaler_state = tres.state_from_numpy(raw["scaler"], device="cpu")
    return tr


def _port_snap(tr, level):
    """The port trainer's state as the flat lists of ``_jax_run``."""
    f = lambda t: t.float().numpy().copy()  # noqa: E731
    inner = tr.opt_state["inner"] if level in ARENA_LEVELS else (tr.opt_state,)
    params = tr.params.arenas if level in ARENA_LEVELS else tree_flatten(tr.params)[0]
    state = {"params": [f(t) for t in params],
             "mom": [f(a) for b in inner for a in tree_flatten(b["momentum_buffer"])[0]],
             "steps": [int(b["step"]) for b in inner],
             "bn": [f(t) for t in tree_flatten(tr.bn_state)[0]],
             "masters": [f(t) for t in tr.opt_state.get("master", ())]}
    if level in ARENA_LEVELS:
        # the model arena is the masters' cast, bit for bit
        state["model_is_master_cast"] = all(
            torch.equal(a, m.to(a.dtype))
            for a, m in zip(tr.params.arenas, tr.opt_state["master"]))
    return state


@pytest.fixture(scope="module", params=LEVELS)
def runs(request):
    level = request.param
    raws, jstates, jmetrics = _jax_run(level)
    tr = _port_trainer(level)
    tstates, tmetrics = [], []
    for images, labels in _batches():
        m = tr.step(*tr.shard_batch(images, labels), LR)
        tmetrics.append({k: float(v) for k, v in m.items()})
        tstates.append(_port_snap(tr, level))
    return level, raws, jstates, jmetrics, tstates, tmetrics


# O0: fp32 throughout. O5: bf16 convolutions and activations, rounded at
# other places by XLA and PyTorch: the bf16 model arenas one bf16 ulp apart,
# the masters by lr times the momentum's difference. The momentum (a sum of
# gradients) of either level to a relative L2 bound: one ReLU input on the
# other side of 0 moves a gradient by a few percent here (module docstring)
TOL = {
    "O0": dict(loss=1e-5, params=1e-5, masters=0.0, bn=1e-5, mom_l2=3e-2),
    "O5": dict(loss=1e-3, params=2 ** -7, masters=LR * 5e-2, bn=2e-3, mom_l2=1e-1),
}


def _check_state(t, j, tol):
    for a, b in zip(t["params"], j["params"]):
        np.testing.assert_allclose(a, b, rtol=tol["params"], atol=tol["params"])
    for a, b in zip(t["masters"], j["masters"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol["masters"])
    for a, b in zip(t["mom"], j["mom"]):
        assert np.linalg.norm(a - b) <= tol["mom_l2"] * np.linalg.norm(b)
    for a, b in zip(t["bn"], j["bn"]):
        np.testing.assert_allclose(a, b, rtol=tol["bn"], atol=tol["bn"] * np.abs(b).max())
    assert t["steps"] == j["steps"]
    for key in ("params", "masters", "mom", "bn"):
        assert len(t[key]) == len(j[key])


@pytest.mark.parametrize("step", range(STEPS))
def test_trainer_matches_jax_free_running(runs, step):
    """Loss, found_inf, accuracy, params (O5: the model arenas; the masters
    are their cast), momentum, step counts and BN state after each of three
    steps."""
    level, _, jstates, jmetrics, tstates, tmetrics = runs
    tol = TOL[level]
    t, j = tstates[step], jstates[step + 1]
    jm, tm = jmetrics[step], tmetrics[step]
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=tol["loss"])
    assert tm["found_inf"] == jm["found_inf"] == 0.0
    assert abs(tm["prec1"] - jm["prec1"]) <= 100.0 / BATCH
    assert t["steps"] == [step + 1] * len(t["steps"])
    _check_state(t, j, tol)
    if level == "O5":
        assert t["model_is_master_cast"]


@pytest.mark.parametrize("step", range(STEPS))
def test_one_step_from_jax_state(runs, step):
    """The port's trainer loaded with the JAX trainer's state before step
    ``step`` (through the numpy loaders) lands on the JAX state after it:
    loss, params, masters, momentum, step counts and BN state."""
    level, raws, jstates, jmetrics, _, _ = runs
    tol = TOL[level]
    tr = _port_trainer(level, raws[step])
    images, labels = _batches()[step]
    m = tr.step(*tr.shard_batch(images, labels), LR)
    np.testing.assert_allclose(m["loss"].item(), jmetrics[step]["loss"],
                               rtol=tol["loss"])
    _check_state(_port_snap(tr, level), jstates[step + 1], tol)


def test_loss_falls(runs):
    losses = [m["loss"] for m in runs[5]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_o5_keeps_bn_fp32_and_casts_convs_and_fc():
    tr = _port_trainer("O5")
    assert isinstance(tr.params, PackedParams)
    p = tr.params.unpack()
    assert p["conv1"].dtype == torch.bfloat16
    assert p["fc"]["w"].dtype == p["fc"]["b"].dtype == torch.bfloat16
    assert p["bn1"].scale.dtype == torch.float32
    assert p["layer2"]["0"]["downsample_bn"].bias.dtype == torch.float32
    assert [m.dtype for m in tr.opt_state["master"]] == [torch.float32] * 2
    assert tr.bn_state["bn1"].running_mean.dtype == torch.float32
    o0 = _port_trainer("O0")
    assert not isinstance(o0.params, PackedParams) and "master" not in o0.opt_state


@pytest.mark.parametrize("level", LEVELS)
def test_skip_step_holds_params_and_advances_bn(level):
    """A loss weighted by inf (a static loss scale of inf): found_inf, the
    params (O5: model arenas and masters), momentum and step counts
    unchanged; the BN running stats advance all the same, as in the JAX
    trainer."""
    tr = _port_trainer(level, loss_scale=float("inf"))
    before = _port_snap(tr, level)
    images, labels = _batches()[0]
    m = tr.step(*tr.shard_batch(images, labels), LR)
    after = _port_snap(tr, level)
    assert bool(m["found_inf"])
    for key in ("params", "mom") + (("masters",) if level == "O5" else ()):
        for a, b in zip(after[key], before[key]):
            np.testing.assert_array_equal(a, b)
    assert after["steps"] == [0] * len(after["steps"])
    assert not np.array_equal(after["bn"][0], before["bn"][0])


# ------------------------------------------------------------- O1-O4
#
# O1-O4 against the JAX trainer, free-running as above. About twice the
# worst measured (PERF.md): fp16 (O1-O3) keeps 3 more bits than bf16, so the
# loss, params, masters and BN state agree to fp16 rounding. The momentum
# is held twice: each leaf (each arena at O2) to ``mom_l2`` and the whole
# tree to ``mom_all``. The leaves that part most are the BatchNorm scales
# and biases of the width-8 net (bn1, layer1/0/bn1, layer2/0/bn1): each
# gradient is a sum over the batch that cancels, so one rounding of the
# low-precision backward moves it by a share of its size. The per-leaf
# readings are those of O5 (bf16) and O2 (fp16) on the same leaves:
# O4's and O1's first steps are O5's and O2's in each package
# (``test_autocast_first_step_is_its_storage_twins``); the readings over
# four seeds come from running this file as a script.
AMP_TOL = {
    "O1": dict(loss=1e-4, params=2e-5, masters=0.0, bn=1e-4, mom_l2=8e-2,
               mom_all=2e-2),
    "O2": dict(loss=1e-4, params=2 ** -10, masters=LR * 5e-3, bn=1e-4, mom_l2=2e-2,
               mom_all=2e-2),
    "O3": dict(loss=1e-4, params=2 ** -10, masters=0.0, bn=1e-4, mom_l2=2e-2,
               mom_all=2e-2),
    "O4": dict(loss=5e-4, params=2e-4, masters=0.0, bn=3e-3, mom_l2=4e-1,
               mom_all=1e-1),
}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _momentum_leaves(level, seed=0, steps=STEPS):
    """``(names, [(jax leaves, port leaves) after each step])``: each
    package's momentum leaf by leaf (the arena levels' momentum arenas
    unpacked) from the init drawn from ``seed``, on the batches of seed
    ``7 + seed``."""
    jtr = jmain.build_trainer(cfg=jres.tiny_test_config(), opt_level=level,
                              global_batch=BATCH, num_classes=CLASSES,
                              distributed=False, devices=jax.devices()[:1],
                              seed=seed)
    tr = _port_trainer(level, seed=seed)

    def tree(t):
        if level in ARENA_LEVELS:
            return t.params.replace_arenas(
                [b["momentum_buffer"] for b in t.opt_state["inner"]]).unpack()
        return t.opt_state["momentum_buffer"]

    out = []
    for images, labels in _batches(7 + seed)[:steps]:
        jtr.step(*jtr.shard_batch(images, labels), LR)
        tr.step(*tr.shard_batch(images, labels), LR)
        out.append(([_f32(a) for a in jax.tree.leaves(tree(jtr))],
                    [t.float().numpy().copy() for t in tree_flatten(tree(tr))[0]]))
    names = ["/".join(map(str, q)) for q in tree_paths(tree(tr))]
    return names, out


@pytest.mark.parametrize("level,twin", [("O4", "O5"), ("O1", "O2")])
def test_autocast_first_step_is_its_storage_twins(level, twin):
    """The witness for the O4 and O1 momentum bounds: at the first step
    O4 (fp32 storage under a bf16 scope) takes O5's step (bf16 storage),
    and O1 O2's, leaf for leaf in each package (over four seeds at most
    1.75e-3 of a leaf's L2 norm in JAX at O4, 2.5e-5 in the port, 2.9e-6
    at O1), so each leaf's gap between the packages is the storage
    level's (the two gaps agree to 1.9e-4 at most): up to 0.24 of a
    BatchNorm leaf at O4 and O5 (PERF.md). Bounds about twice those."""
    (_, [(ja, ta)]), (_, [(jb, tb)]) = (_momentum_leaves(lv, steps=1)
                                        for lv in (level, twin))
    for a, b in [*zip(ja, jb), *zip(ta, tb)]:
        assert _rel_l2(a, b) <= 4e-3
    np.testing.assert_allclose([_rel_l2(t, j) for t, j in zip(ta, ja)],
                               [_rel_l2(t, j) for t, j in zip(tb, jb)], atol=4e-4)


@pytest.fixture(scope="module", params=AMP_LEVELS)
def amp_runs(request):
    level = request.param
    _, jstates, jmetrics = _jax_run(level)
    tr = _port_trainer(level)
    tstates, tmetrics = [], []
    for images, labels in _batches():
        m = tr.step(*tr.shard_batch(images, labels), LR)
        tmetrics.append({k: float(v) for k, v in m.items()})
        tstates.append(_port_snap(tr, level))
    return level, jstates, jmetrics, tstates, tmetrics


@pytest.mark.parametrize("step", range(STEPS))
def test_amp_levels_match_jax_free_running(amp_runs, step):
    """O1-O4: loss, found_inf, the dynamic scale (2^16 at O1/O2), accuracy,
    params (O2: the fp16 and fp32 model arenas, the masters' cast),
    momentum, step counts and BN state after each of three steps."""
    level, jstates, jmetrics, tstates, tmetrics = amp_runs
    tol = AMP_TOL[level]
    t, j = tstates[step], jstates[step + 1]
    jm, tm = jmetrics[step], tmetrics[step]
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=tol["loss"])
    assert tm["found_inf"] == jm["found_inf"] == 0.0
    assert tm["scale"] == jm["scale"] == (2.0 ** 16 if level in ("O1", "O2") else 1.0)
    assert abs(tm["prec1"] - jm["prec1"]) <= 100.0 / BATCH
    assert t["steps"] == [step + 1] * len(t["steps"])
    _check_state(t, j, tol)
    whole = [np.concatenate([a.ravel() for a in x["mom"]]) for x in (t, j)]
    assert _rel_l2(*whole) <= tol["mom_all"]
    if level in ARENA_LEVELS:
        assert t["model_is_master_cast"]


@pytest.mark.parametrize("level", AMP_LEVELS)
def test_amp_storage_matches_jax(level):
    """O2 keeps BN fp32 and casts the convolutions and fc to fp16 in
    PackedParams (JAX's test_o2_keeps_bn_fp32_and_casts_convs); O3 casts
    every leaf to fp16 with fp32 momentum; O1 and O4 keep the fp32 tree."""
    tr = _port_trainer(level)
    jtr = jmain.build_trainer(cfg=jres.tiny_test_config(), opt_level=level,
                              global_batch=BATCH, num_classes=CLASSES,
                              distributed=False, devices=jax.devices()[:1])
    if level == "O2":
        assert isinstance(tr.params, PackedParams)
        p = tr.params.unpack()
        assert p["conv1"].dtype == p["fc"]["w"].dtype == torch.float16
        assert p["bn1"].scale.dtype == torch.float32
        assert p["layer2"]["0"]["downsample_bn"].bias.dtype == torch.float32
        jleaves = jax.tree.leaves(jtr.params.unpack())
    else:
        p = tr.params
        jleaves = jax.tree.leaves(jtr.params)
        assert all(b.dtype == torch.float32 for b in
                   tree_flatten(tr.opt_state["momentum_buffer"])[0])
    assert [str(a.dtype)[6:] for a in tree_flatten(p)[0]] == [
        a.dtype.name for a in jleaves]


def test_o2_overflow_skips_without_poisoning_params():
    """O2 at a loss scale of 2^24 (JAX's
    test_dynamic_scaler_skips_do_not_poison_params): the fp16 gradients
    overflow, the step is skipped and the model arenas, masters and momentum
    stay bitwise the same, in both packages."""
    tr = _port_trainer("O2", loss_scale=2.0 ** 24)
    jtr = jmain.build_trainer(cfg=jres.tiny_test_config(), opt_level="O2",
                              global_batch=BATCH, num_classes=CLASSES,
                              distributed=False, devices=jax.devices()[:1],
                              loss_scale=2.0 ** 24)
    images, labels = _batches()[0]
    before = _port_snap(tr, "O2")
    jbefore = jax.tree.map(lambda x: np.asarray(x).copy(), jtr.params)
    m = tr.step(*tr.shard_batch(images, labels), LR)
    jm = jtr.step(*jtr.shard_batch(images, labels), LR)
    assert bool(m["found_inf"]) and bool(jm["found_inf"])
    after = _port_snap(tr, "O2")
    for key in ("params", "masters", "mom"):
        for a, b in zip(after[key], before[key]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(jtr.params), jax.tree.leaves(jbefore)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert after["steps"] == [0, 0]


def test_eval_step_matches_jax():
    jtr = jmain.build_trainer(cfg=jres.tiny_test_config(), opt_level="O0",
                              global_batch=BATCH, num_classes=CLASSES,
                              distributed=False, devices=jax.devices()[:1])
    ttr = _port_trainer("O0")
    images, labels = _batches()[0]
    jm = jtr.evaluate(*jtr.shard_batch(images, labels))
    tm = ttr.evaluate(*ttr.shard_batch(images, labels))
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    for k in ("prec1", "prec5"):
        assert tm[k].item() == pytest.approx(float(jm[k]))


def test_loss_and_accuracy_helpers_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((32, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 32)
    jl = jmain.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tl = tmain.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    ja = jmain.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels))
    ta = tmain.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert {k: v.item() for k, v in ta.items()} == pytest.approx(
        {k: float(v) for k, v in ja.items()})


def test_schedule_and_batches_match_jax():
    for epoch, step in ((0, 0), (2, 7), (4, 9), (30, 1), (61, 0), (90, 3)):
        assert tmain.adjust_learning_rate(0.05, epoch, step, 10) == \
            jmain.adjust_learning_rate(0.05, epoch, step, 10)
    for (a, b), (c, d) in zip(tmain.synthetic_batches(4, 8, 10, 2),
                              jmain.synthetic_batches(4, 8, 10, 2)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_train_loop_prints_and_returns_speed(capsys):
    tr = _port_trainer("O5")
    speed = tmain.train(tr, iters=2, image_size=HW, base_lr=0.1, print_freq=1)
    out = capsys.readouterr().out
    assert speed > 0 and out.count("Epoch: [0]") == 2 and "Loss" in out


def test_main_runs_on_the_cpu(capsys):
    best = tmain.main(["-a", "resnet18", "-b", "2", "--image-size", "16",
                       "--num-classes", "10", "--iters", "1", "--opt-level", "O5",
                       "--deterministic", "--device", "cpu"])
    assert best > 0 and "peak speed" in capsys.readouterr().out


# ------------------------------------------------------ amp has_state / has_aux


def _toy(p, state, x):
    """A model with state: y = x @ w, the state counting calls, uncast."""
    assert state["count"].dtype == torch.float32
    return x @ p["w"], {"count": state["count"] + 1}


def test_make_apply_passes_state_uncast():
    policy = tamp.opt_levels["O5"]
    apply = tamp.make_apply(policy, _toy, has_state=True)
    p = {"w": torch.ones(3, 2, dtype=torch.bfloat16)}
    out, new = apply(p, {"count": torch.zeros((), dtype=torch.float32)},
                     torch.ones(4, 3))
    assert out.dtype == torch.float32 and new["count"].dtype == torch.float32
    assert new["count"].item() == 1 and torch.equal(out, torch.full((4, 2), 3.0))
    m = tamp.initialize(_toy, p, None, "O5", has_state=True)
    out2, _ = m.apply(m.params, {"count": torch.zeros(())}, torch.ones(4, 3))
    assert torch.equal(out2, out)


@pytest.mark.parametrize("packed", [False, True])
def test_scaled_value_and_grad_has_aux_matches_jax(packed):
    """``(loss, aux, grads, found_inf, new_state)``, the aux detached; the
    same loss, aux and grads as the JAX function on the same inputs."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    x = rng.standard_normal((4, 3)).astype(np.float32)

    def jloss(p, x):
        y = x @ p["w"]
        return jnp.mean(y * y), {"y": y}

    def tloss(p, x):
        if isinstance(p, PackedParams):
            p = p.unpack()
        y = x @ p["w"]
        return (y * y).mean(), {"y": y}

    jscaler = jamp.LossScaler(loss_scale=4.0)
    jl, jaux, jg, jfi, _ = jamp.scaled_value_and_grad(jloss, jscaler, has_aux=True)(
        {"w": jnp.asarray(w)}, jscaler.init(), jnp.asarray(x))
    tscaler = tamp.LossScaler(loss_scale=4.0)
    params = {"w": torch.from_numpy(w)}
    if packed:
        params = PackedParams.pack(params)
    tl, taux, tg, tfi, tstate = tamp.scaled_value_and_grad(
        tloss, tscaler, has_aux=True)(params, tscaler.init(device="cpu"),
                                      torch.from_numpy(x))
    assert not taux["y"].requires_grad and not bool(tfi)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(taux["y"].numpy(), np.asarray(jaux["y"]), rtol=1e-6)
    grad = tg.unpack()["w"] if packed else tg["w"]
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg["w"]), rtol=1e-6, atol=1e-7)
    assert tstate["scale"].item() == 4.0


# ------------------------------------------ other fused optimizers and LARC


# name -> (JAX optimizer, the port's, the options both trainers get): the
# optimizers' defaults, lr from the trainer's step
OPTIMIZERS = {
    "adagrad": (lambda: jopt.FusedAdagrad(weight_decay=1e-4),
                lambda: topt.FusedAdagrad(weight_decay=1e-4), {}),
    "novograd": (lambda: jopt.FusedNovoGrad(weight_decay=1e-4),
                 lambda: topt.FusedNovoGrad(weight_decay=1e-4), {}),
    "lars": (lambda: jopt.FusedLARS(LR, momentum=0.9, weight_decay=1e-4),
             lambda: topt.FusedLARS(LR, momentum=0.9, weight_decay=1e-4), {}),
    "larc": (lambda: None, lambda: None, dict(use_larc=True, weight_decay=0.0)),
}
# (max |param| difference, each optimizer state leaf's relative L2 bound)
# by optimizer and level, three free-running steps; PERF.md gives the
# measured values. Adagrad's first step moves each weight by lr·g/|g|, so a
# gradient whose sign differs (a ReLU input within rounding of 0; bf16
# rounded at other places at O5) parts the two by 2·lr a step. The others
# scale the gradient by per-tensor norms: about 5 times the worst measured.
# The states are held leaf by leaf (the FusedSGD bounds above are over
# whole arenas), and this width-8 net's small leaves part most: at O5 their
# bf16 gradients differ by up to 19% on the first step; squares (Adagrad's
# sums, NovoGrad's v) double the gradients' relative difference
OPT_TOL = {
    ("adagrad", "O0"): (3 * 2 * LR + 1e-6, 6e-2),
    ("adagrad", "O5"): (3 * 2 * LR + 1e-6, 4e-1),
    ("novograd", "O0"): (1e-4, 6e-2),
    ("novograd", "O5"): (1e-3, 4e-1),
    ("lars", "O0"): (1e-5, 3e-2),
    ("lars", "O5"): (1e-4, 3e-1),
    ("larc", "O0"): (3e-5, 3e-2),
    ("larc", "O5"): (3e-4, 3e-1),
}


def _optimizer_runs(name, level):
    """Both trainers with optimizer ``name`` from the same initial weights
    for STEPS steps on the same batches; yields, after each step, the two
    losses and the two sides' (master) params, optimizer state leaves by
    key, and step counts, as numpy."""
    make_j, make_t, kw = OPTIMIZERS[name]
    jtr = jmain.build_trainer(cfg=jres.tiny_test_config(), opt_level=level,
                              global_batch=BATCH, num_classes=CLASSES,
                              distributed=False, devices=jax.devices()[:1],
                              fused_optimizer=make_j(), **kw)
    ttr = _port_trainer(level, fused_optimizer=make_t(), **kw)

    def snap(tr, leaves):
        inner = tr.opt_state["inner"] if level == "O5" else tr.opt_state
        params = tr.opt_state["master"] if level == "O5" else tr.params
        return (leaves(params),
                {k: leaves(v) for k, v in inner.items() if k != "step"},
                int(inner["step"]))

    jleaves = lambda t: [_f32(a) for a in jax.tree.leaves(t)]  # noqa: E731
    tleaves = lambda t: [a.float().numpy() for a in tree_flatten(t)[0]]  # noqa: E731
    for images, labels in _batches():
        jm = jtr.step(*jtr.shard_batch(images, labels), LR)
        tm = ttr.step(*ttr.shard_batch(images, labels), LR)
        yield (float(jm["loss"]), float(tm["loss"]), snap(jtr, jleaves),
               snap(ttr, tleaves))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_trainer_with_optimizer_matches_jax(name, level):
    """``build_trainer(fused_optimizer=FusedAdagrad / FusedNovoGrad /
    FusedLARS(...))`` and ``build_trainer(use_larc=True,
    weight_decay=0.0)`` (LARC around FusedSGD) at O0 and O5, the list path
    over fp32 masters, against the JAX trainer, three steps: the loss, the
    step count, every (master) param and every optimizer state leaf
    (``OPT_TOL``)."""
    params_tol, state_l2 = OPT_TOL[name, level]
    for i, (jloss, tloss, jstate, tstate) in enumerate(_optimizer_runs(name, level)):
        np.testing.assert_allclose(tloss, jloss, rtol=TOL[level]["loss"])
        assert tstate[2] == jstate[2] == i + 1
        assert len(tstate[0]) == len(jstate[0])
        for a, b in zip(tstate[0], jstate[0]):
            np.testing.assert_allclose(a, b, rtol=0, atol=params_tol)
        assert tstate[1].keys() == jstate[1].keys()
        for key, refs in jstate[1].items():
            assert len(tstate[1][key]) == len(refs)
            for a, b in zip(tstate[1][key], refs):
                assert a.shape == b.shape
                assert np.linalg.norm(a - b) <= state_l2 * np.linalg.norm(b)


def test_larc_refuses_an_inner_decay():
    """As the JAX trainer: ``use_larc`` wraps FusedSGD(weight_decay=...)
    in LARC, which refuses an inner decay, so the default decay raises; the
    CLI's ``--larc`` likewise, and runs with ``--wd 0``."""
    with pytest.raises(ValueError, match="weight decay"):
        jmain.build_trainer(cfg=jres.tiny_test_config(), use_larc=True,
                            distributed=False, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="weight decay"):
        tmain.build_trainer(cfg=tres.tiny_test_config(), use_larc=True,
                            device="cpu")
    with pytest.raises(ValueError, match="weight decay"):
        tmain.main(["--larc", "-a", "resnet18", "--device", "cpu"])
    tr = tmain.build_trainer(cfg=tres.tiny_test_config(), use_larc=True,
                             weight_decay=0.0, device="cpu")
    assert isinstance(tr.amp_model.optimizer, LARC)
    assert not isinstance(tr.params, PackedParams)


def test_main_runs_with_larc_on_the_cpu(capsys):
    best = tmain.main(["-a", "resnet18", "-b", "2", "--image-size", "16",
                       "--num-classes", "10", "--iters", "1", "--opt-level", "O5",
                       "--larc", "--wd", "0", "--deterministic", "--device", "cpu"])
    assert best > 0 and "peak speed" in capsys.readouterr().out


# ------------------------------------------------------------ not ported


@pytest.mark.parametrize("kw", [
    dict(distributed=True), dict(sync_bn=True),
    dict(bucket_bytes=1 << 20), dict(compress=True), dict(overlap_backward=True),
])
def test_unported_options_raise(kw):
    """The data-parallel options are ported (tests/test_torch_ddp.py); a
    distributed trainer with no initialized process group raises instead
    of quietly training on one rank."""
    with pytest.raises(RuntimeError, match="process group"):
        tmain.build_trainer(cfg=tres.tiny_test_config(), device="cpu",
                            **{"distributed": True, **kw})


@pytest.mark.parametrize("flag", ["--profile-dir", "--flight-recorder"])
def test_unported_cli_flags_raise(flag, tmp_path, capsys):
    """Both flags are ported (the monitor): ``--profile-dir`` writes a
    profiler trace of the first epoch into its directory, and
    ``--flight-recorder`` dumps the ring of printed steps at the end of the
    run on the CPU."""
    target = tmp_path / "x"
    best = tmain.main([flag, str(target), "-a", "resnet18", "-b", "2",
                       "--image-size", "16", "--num-classes", "10", "--iters", "2",
                       "--print-freq", "1", "--opt-level", "O5", "--deterministic",
                       "--device", "cpu"])
    assert best > 0 and "peak speed" in capsys.readouterr().out
    if flag == "--profile-dir":
        traces = list(target.glob("*.pt.trace.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any(e.get("name") == "aten::convolution" for e in events)
    else:
        dump = json.loads(target.read_text())
        assert dump["reason"] == "run_end" and dump["n_snapshots"] == 2
        assert [s["step"] for s in dump["snapshots"]] == [1, 2]
        assert set(dump["snapshots"][0]["metrics"]) >= {"loss", "prec1", "scale"}


def test_unported_flight_recorder_and_half_weights_raise(tmp_path):
    """``train(flight=)`` records every printed row (the rows the print
    cadence reads back anyway); half-precision weights still raise."""
    from beforeholiday_tpu_torch.monitor import FlightRecorder

    tr = _port_trainer("O0")
    fr = FlightRecorder(4, path=str(tmp_path / "f.json"))
    tmain.train(tr, iters=3, image_size=HW, print_freq=2, flight=fr, epoch=1)
    snaps = fr.snapshots()
    assert [s["step"] for s in snaps] == [5, 6]
    assert all(isinstance(v, float) for v in snaps[0]["metrics"].values())
    with pytest.raises(ValueError):
        tmain.build_trainer(cfg=tres.tiny_test_config(), device="cpu",
                            params=tr.params)


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tmain.build_trainer(cfg=tres.tiny_test_config())
    assert tmain.build_trainer(cfg=tres.tiny_test_config(), device="cpu").device.type == "cpu"


if __name__ == "__main__":
    # the momentum readings behind AMP_TOL (PERF.md): for each seed and
    # level, the worst per-leaf relative L2 gap between the packages after
    # each step, the whole tree's, and the leaves that part most at step 3
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_imagenet.py
    with torch.backends.mkldnn.flags(enabled=False):
        for seed in range(4):
            for level in ("O1", "O2", "O3", "O4", "O5"):
                names, steps = _momentum_leaves(level, seed)
                per = [[_rel_l2(t, j) for j, t in zip(js, ts)] for js, ts in steps]
                whole = [_rel_l2(*(np.concatenate([a.ravel() for a in x])
                                   for x in (ts, js))) for js, ts in steps]
                top = sorted(zip(per[-1], names), reverse=True)[:3]
                print(f"seed {seed} {level}: per-leaf worst "
                      f"{' '.join(f'{max(p):.4f}' for p in per)}; whole tree "
                      f"{' '.join(f'{w:.4f}' for w in whole)}; step 3 "
                      + ", ".join(f"{n} {r:.4f}" for r, n in top), flush=True)
