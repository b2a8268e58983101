"""Port parity: ``models/resnet.py`` and ``parallel/sync_batch_norm.py``
against the JAX package on the same numpy weights and inputs, on the CPU in
fp32 (forward in train and eval mode, running stats, grads via
``jax.grad``), the parameter counts of the presets, the O5 ``ArenaSpec``s of
ResNet-50, the numpy loaders' namedtuples, and BatchNorm in both ``stats``
modes with ``fuse_relu``, ``residual`` and the diagnostics flag.

Tolerances (PERF.md's table): fp32 convolutions and reductions summed in
another order by XLA and by PyTorch's CPU kernels, so 1e-5-class bounds,
scaled by the largest value where values of all sizes share one bound.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import amp as jamp
from beforeholiday_tpu.models import resnet as jres
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.amp.frontend import _default_keep_fp32
from beforeholiday_tpu_torch.models import resnet as tres
from beforeholiday_tpu_torch.ops.arena import (
    tree_flatten,
    tree_map,
    tree_paths,
    tree_unflatten,
)

# the modules (each package's ``parallel`` exports the function of the same
# name, which shadows the module as an attribute)
jbn = importlib.import_module("beforeholiday_tpu.parallel.sync_batch_norm")
tbn = importlib.import_module("beforeholiday_tpu_torch.parallel.sync_batch_norm")

# a bottleneck net with the stem's 7x7/2 conv, the max-pool and a
# downsampling block, small enough for the CPU
BOTTLENECK = dict(block="bottleneck", layers=(1, 1), width=8, num_classes=10)
CONFIGS = {"tiny": (dict(), 16), "bottleneck": (BOTTLENECK, 32)}


@pytest.fixture(autouse=True, scope="module")
def _native_cpu_convs():
    """PyTorch's CPU oneDNN convolution backward frees memory twice on a
    1x1 stride-2 channels-last convolution (ResNet's downsample) in the
    CPU build these tests run on; they take PyTorch's native CPU
    convolutions instead."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _cfgs(name):
    kw, hw = CONFIGS[name]
    if not kw:
        return jres.tiny_test_config(), tres.tiny_test_config(), hw
    return jres.ResNetConfig(**kw), tres.ResNetConfig(**kw), hw


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rel=1e-5):
    """|got - ref| <= rel * (|ref| + max|ref|): 1e-5 of the value, and of the
    tensor's largest value where sums of all sizes meet."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg, tcfg, hw = _cfgs(request.param)
    jp, js = jres.init(jax.random.PRNGKey(0), jcfg)
    # running stats away from their init, so eval mode uses them
    rng = np.random.default_rng(5)
    js = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.random(a.shape, dtype=np.float32)), js)
    nps, nss = jax.tree.map(np.asarray, (jp, js))
    x = rng.standard_normal((4, hw, hw, 3)).astype(np.float32)
    return (jcfg, jp, js), (tcfg, tres.params_from_numpy(nps, device="cpu"),
                            tres.state_from_numpy(nss, device="cpu")), x


@pytest.mark.parametrize("training", [True, False])
def test_forward_and_running_stats_match_jax(model, training):
    (jcfg, jp, js), (tcfg, tp, ts), x = model
    jl, jns = jres.forward(jp, js, jnp.asarray(x), jcfg, training=training)
    tl, tns = tres.forward(tp, ts, torch.from_numpy(x), tcfg, training=training)
    assert tl.shape == (4, tcfg.num_classes) and tl.dtype == torch.float32
    _close(tl.numpy(), jl)
    jleaves = jax.tree.leaves(jns)
    tleaves = tree_flatten(tns)[0]
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        _close(a.numpy(), b)


def test_grads_match_jax(model):
    """Grads of a weighted logit sum in training mode for every parameter
    (convs, BN scale and bias, fc), through the batch statistics."""
    (jcfg, jp, js), (tcfg, tp, ts), x = model
    w = np.random.default_rng(6).standard_normal((4, jcfg.num_classes)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jres.forward(p, js, jnp.asarray(x), jcfg)[0] * w)

    jg = jax.grad(jloss)(jp)
    leaves = [t.clone().requires_grad_(True) for t in tree_flatten(tp)[0]]
    treedef = tree_flatten(tp)[1]
    logits, _ = tres.forward(tree_unflatten(treedef, leaves), ts,
                             torch.from_numpy(x), tcfg)
    (logits * torch.from_numpy(w)).sum().backward()
    for path, a, b in zip(tree_paths(tp), leaves, jax.tree.leaves(jg)):
        assert a.grad.shape == b.shape, path
        _close(a.grad.numpy(), b, rel=1e-5)


@pytest.mark.parametrize("name, count", [("resnet50", 25_557_032),
                                         ("resnet18", 11_689_512)])
def test_parameter_counts(name, count):
    p, s = tres.init(tres.CONFIGS[name](), torch.Generator().manual_seed(0),
                     device="cpu")
    assert sum(t.numel() for t in tree_flatten(p)[0]) == count
    jshape = jax.eval_shape(lambda k: jres.init(k, jres.CONFIGS[name]()),
                            jax.random.PRNGKey(0))
    for a, b in zip(tree_flatten((p, s))[0], jax.tree.leaves(jshape)):
        assert tuple(a.shape) == b.shape


def test_init_distributions():
    """The port's init draws from the reference's distributions: Kaiming
    normal (fan_out) convs, BN 1/0, running stats 0/1, fc uniform."""
    cfg = tres.resnet18(num_classes=100)
    p, s = tres.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    w = p["layer3"]["0"]["conv2"]  # 3x3, 256 -> 256
    np.testing.assert_allclose(float(w.std()), (2.0 / (9 * 256)) ** 0.5, rtol=0.02)
    assert torch.equal(p["bn1"].scale, torch.ones(64))
    assert torch.equal(s["layer1"]["0"]["bn2"].running_var, torch.ones(64))
    bound = 1 / 512 ** 0.5
    assert float(p["fc"]["w"].abs().max()) <= bound
    zero = tres.init(tres.resnet18(zero_init_residual=True),
                     torch.Generator().manual_seed(0), device="cpu")[0]
    assert not zero["layer2"]["1"]["bn2"].scale.any()


@pytest.mark.parametrize("name", ["resnet50", "resnet18"])
def test_o5_arena_specs_match_jax(name):
    """amp O5 arena-native packing: the same buckets (bf16 convs and fc,
    fp32 BN), tensor order, offsets and padding as the JAX package."""
    jshape = jax.eval_shape(lambda k: jres.init(k, jres.CONFIGS[name]()),
                            jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jshape[0])
    jm = jamp.initialize(lambda p, s, x: (x, s), jp, None, "O5",
                         arena_native=True, has_state=True)
    tp = tree_map(lambda a: torch.zeros(a.shape), tres.init(
        tres.CONFIGS[name](), torch.Generator().manual_seed(0), device="cpu")[0])
    tm = tamp.initialize(lambda p, s, x: (x, s), tp, None, "O5",
                         arena_native=True, has_state=True)
    jl, tl = jm.params.layout, tm.params.layout
    assert [str(d) for d in jl.dtypes] == ["bfloat16", "float32"]
    assert tl.dtypes == (torch.bfloat16, torch.float32)
    assert tl.indices == jl.indices
    for a, b in zip(tl.specs, jl.specs):
        assert (a.shapes, a.offsets, a.total, a.padded_total) == (
            b.shapes, b.offsets, b.total, b.padded_total)
    if name == "resnet50":
        assert [s.total for s in tl.specs] == [25_503_912, 53_120]
        assert [s.padded_total for s in tl.specs] == [25_526_272, 65_536]
        assert len(tree_flatten(tp)[0]) == 161


def test_numpy_loaders_keep_namedtuples(model):
    """``params_from_numpy``/``state_from_numpy`` map the JAX namedtuples to
    the port's classes (a (C,) scale stays (C,), not a stacked (2, C)), and
    the leaves come out in JAX's order."""
    (jcfg, jp, js), (tcfg, tp, ts), _ = model
    assert type(tp["bn1"]) is tbn.BatchNormParams
    assert type(ts["layer1"]["0"]["bn1"]) is tbn.BatchNormState
    assert tp["bn1"].scale.shape == (jcfg.width,)
    for a, b in zip(tree_flatten((tp, ts))[0], jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    from collections import namedtuple

    Other = namedtuple("Other", ["a"])
    with pytest.raises(ValueError):
        tres.params_from_numpy({"x": Other(np.zeros(2, np.float32))}, device="cpu")


def test_paths_name_fields_and_keep_bn_fp32():
    """Paths to namedtuple fields carry the field name, and the keep rule
    keeps every BN (``bn1``, ``downsample_bn``) fp32, as JAX's does."""
    p, _ = tres.init(tres.resnet18(), torch.Generator().manual_seed(0), device="cpu")
    paths = tree_paths(p)
    assert ("bn1", "scale") in paths and ("bn1", "bias") in paths
    kept = [path for path in paths if _default_keep_fp32(path)]
    assert ("layer2", "0", "downsample_bn", "bias") in kept
    assert all(any(str(k).endswith("bn") or str(k).startswith("bn") for k in path)
               for path in kept)
    assert len(kept) == 2 * 20  # 20 BatchNorms in ResNet-18


def test_maxpool_pads_with_minus_inf():
    """F.max_pool2d(3, 2, 1) equals the JAX reduce_window with -inf padding,
    at the edges too (all-negative inputs, odd and even sizes)."""
    rng = np.random.default_rng(7)
    for hw in (7, 8):
        x = (-1.0 - rng.random((2, hw, hw, 3))).astype(np.float32)
        ref = jres._maxpool_3x3_s2(jnp.asarray(x))
        got = tres._maxpool_3x3_s2(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


# ------------------------------------------------------------- BatchNorm


def _bn_inputs(dtype, channel_last, shift=0.0, seed=8):
    rng = np.random.default_rng(seed)
    shape = (4, 5, 6, 8) if channel_last else (4, 8, 5, 6)
    x = (rng.standard_normal(shape) * 2.0 + 0.5 + shift).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    p = jbn.BatchNormParams(*(jnp.asarray(rng.standard_normal(8).astype(np.float32))
                              for _ in range(2)))
    s = jbn.BatchNormState(jnp.asarray(0.3 * rng.standard_normal(8).astype(np.float32)),
                           jnp.asarray(1.0 + rng.random(8).astype(np.float32)))
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, res, p, s, dy


@pytest.mark.parametrize("stats", ["one_pass_shifted", "two_pass"])
@pytest.mark.parametrize("fuse_relu, residual", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_sync_batch_norm_matches_jax(stats, fuse_relu, residual, channel_last, training):
    """Output, new running stats, diagnostics and the grads of x, scale,
    bias and the residual, fp32."""
    x, res, p, s, dy = _bn_inputs(jnp.float32, channel_last)
    kw = dict(training=training, channel_last=channel_last, fuse_relu=fuse_relu,
              stats=stats, return_diagnostics=True)

    def jfn(x, scale, bias, r):
        y, ns, diag = jbn.sync_batch_norm(
            x, jbn.BatchNormParams(scale, bias), s,
            residual=r if residual else None, **kw)
        return jnp.sum(y * dy), (y, ns, diag)

    (_, (jy, jns, jdiag)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), p.scale, p.bias, jnp.asarray(res))
    tx, tscale, tbias, tres_ = (_t(a).requires_grad_(True)
                                for a in (x, p.scale, p.bias, res))
    ty, tns, tdiag = tbn.sync_batch_norm(
        tx, tbn.BatchNormParams(tscale, tbias),
        tbn.BatchNormState(_t(s.running_mean), _t(s.running_var)),
        residual=tres_ if residual else None, **kw)
    (ty * _t(dy)).sum().backward()
    _close(ty.detach().numpy(), jy)
    for a, b in zip(tns, jns):
        assert not a.requires_grad
        _close(a.numpy(), b)
    assert int(tdiag["bn_shift_dominated"]) == int(jdiag["bn_shift_dominated"]) == 0
    for a, b, used in zip((tx, tscale, tbias, tres_), jgrads,
                          (True, True, True, residual)):
        if used:
            _close(a.grad.numpy(), b, rel=1e-5)
        else:
            assert a.grad is None


def test_sync_batch_norm_bf16_activations():
    """bf16 activations with fp32 BN params (amp O5): fp32 statistics, one
    rounding of the output to bf16, bf16 grads of x and fp32 ones of the
    params."""
    x, _, p, s, dy = _bn_inputs(jnp.float32, False)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    dyb = jnp.asarray(dy).astype(jnp.bfloat16)

    def jfn(x, scale, bias):
        y, ns = jbn.sync_batch_norm(x, jbn.BatchNormParams(scale, bias), s,
                                    fuse_relu=True)
        return jnp.sum((y * dyb).astype(jnp.float32)), (y, ns)

    (_, (jy, jns)), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        xb, p.scale, p.bias)
    tx = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    tx.requires_grad_(True)
    tscale, tbias = (_t(a).requires_grad_(True) for a in (p.scale, p.bias))
    ty, tns = tbn.sync_batch_norm(tx, tbn.BatchNormParams(tscale, tbias),
                                  tbn.BatchNormState(_t(s.running_mean),
                                                     _t(s.running_var)),
                                  fuse_relu=True)
    assert ty.dtype == torch.bfloat16 and tns.running_mean.dtype == torch.float32
    dyt = torch.from_numpy(np.asarray(dyb.astype(jnp.float32))).to(torch.bfloat16)
    (ty * dyt).float().sum().backward()
    # fp32 values rounded once to bf16: one bf16 ulp where they straddle
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy, np.float32), rtol=2 ** -7, atol=2 ** -8)
    for a, b in zip(tns, jns):
        _close(a.numpy(), b)
    assert tx.grad.dtype == torch.bfloat16 and tscale.grad.dtype == torch.float32
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(jg[0], np.float32),
                               rtol=2 ** -7, atol=2e-2 * float(np.abs(jg[0]).max()))
    for a, b in zip((tscale, tbias), jg[1:]):
        _close(a.grad.numpy(), b, rel=1e-3)


def test_shift_dominated_flag():
    """A batch mean 1000 sigma from the running mean trips the
    one_pass_shifted envelope flag on both sides."""
    x, _, p, s, _ = _bn_inputs(jnp.float32, False, shift=1e4)
    _, _, jdiag = jbn.sync_batch_norm(jnp.asarray(x), p, s, return_diagnostics=True)
    _, _, tdiag = tbn.sync_batch_norm(
        _t(x), tbn.BatchNormParams(_t(p.scale), _t(p.bias)),
        tbn.BatchNormState(_t(s.running_mean), _t(s.running_var)),
        return_diagnostics=True)
    assert int(tdiag["bn_shift_dominated"]) == int(jdiag["bn_shift_dominated"]) == 1


def test_init_batch_norm_and_unported_axis():
    params, state = tbn.init_batch_norm(6, device="cpu")
    jparams, jstate = jbn.init_batch_norm(6)
    for a, b in zip((*params, *state), (*jparams, *jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = torch.zeros(2, 6, 3, 3)
    # the cross-device merge is ported (tests/test_torch_ddp.py); without a
    # process group the data axis names no group, and one_pass_shifted
    # refuses an axis, as in JAX
    with pytest.raises(RuntimeError, match="not initialized"):
        tbn.sync_batch_norm(x, params, state, axis_name="data")
    with pytest.raises(ValueError):
        tbn.sync_batch_norm(x, params, state, axis_name="data",
                            stats="one_pass_shifted")
    with pytest.raises(ValueError):
        tbn.sync_batch_norm(x, params, state, stats="welford")
    cfg = tres.tiny_test_config()
    p, s = tres.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        tres.forward(p, s, torch.zeros(2, 16, 16, 3), cfg, axis_name="data")


# ------------------------------------------------ torchvision state dicts


def _torchvision_state_dict(cfg, p, s):
    """The torchvision names and layouts of a params/BN-state tree: conv
    weights (O, I, H, W), fc (O, I); built here, as a user's checkpoint
    would arrive."""
    sd = {}

    def conv(name, w):
        sd[name + ".weight"] = torch.from_numpy(np.array(w).transpose(3, 2, 0, 1).copy())

    def bn(name, bp, bs):
        for k, v in (("weight", bp.scale), ("bias", bp.bias),
                     ("running_mean", bs.running_mean), ("running_var", bs.running_var)):
            sd[f"{name}.{k}"] = torch.from_numpy(np.array(v))

    conv("conv1", p["conv1"])
    bn("bn1", p["bn1"], s["bn1"])
    n_convs = 2 if cfg.block == "basic" else 3
    for i in range(len(cfg.layers)):
        for j in range(cfg.layers[i]):
            bp, bs, base = p[f"layer{i + 1}"][str(j)], s[f"layer{i + 1}"][str(j)], \
                f"layer{i + 1}.{j}"
            for c in range(1, n_convs + 1):
                conv(f"{base}.conv{c}", bp[f"conv{c}"])
                bn(f"{base}.bn{c}", bp[f"bn{c}"], bs[f"bn{c}"])
            if "downsample_conv" in bp:
                conv(f"{base}.downsample.0", bp["downsample_conv"])
                bn(f"{base}.downsample.1", bp["downsample_bn"], bs["downsample_bn"])
    sd["fc.weight"] = torch.from_numpy(np.array(p["fc"]["w"]).T.copy())
    sd["fc.bias"] = torch.from_numpy(np.array(p["fc"]["b"]))
    return sd


def test_from_torch_state_dict_matches_jax(model):
    """The same torchvision-style state dict through both packages'
    ``from_torch_state_dict``: every parameter and running statistic bit for
    bit, the trees of the same structure, and no storage shared with the
    state dict."""
    (jcfg, jp, js), (tcfg, _, _), x = model
    sd = _torchvision_state_dict(jcfg, jp, js)
    jp2, js2 = jres.from_torch_state_dict(jcfg, sd)
    tp2, ts2 = tres.from_torch_state_dict(tcfg, sd, device="cpu")
    for got, ref in ((tp2, jp2), (ts2, js2)):
        tleaves, jleaves = tree_flatten(got)[0], jax.tree.leaves(ref)
        assert [str(a.dtype) for a in tleaves] == ["torch.float32"] * len(jleaves)
        assert [tuple(a.shape) for a in tleaves] == [a.shape for a in jleaves]
        for a, b in zip(tleaves, jleaves):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tree_paths(tp2) == tree_paths(tres.params_from_numpy(
        jax.tree.map(np.asarray, jp2), device="cpu"))
    sd["fc.bias"].add_(1.0)
    assert not torch.equal(tp2["fc"]["b"], sd["fc.bias"])
    tl, _ = tres.forward(tp2, ts2, torch.from_numpy(x), tcfg, training=False)
    jl, _ = jres.forward(jp2, js2, jnp.asarray(x), jcfg, training=False)
    _close(tl.numpy(), jl)
