"""Port parity: the LAMB family over flat arenas — ``l2norm_sq`` and
``multi_tensor_l2norm`` (kernel K9's plain path), ``lamb_flat`` and
``multi_tensor_lamb`` (K7 and K8's plain paths), ``FusedLAMB`` and
``MasterWeights(FusedLAMB)`` — held against the JAX package on the same
numpy inputs. The JAX side runs its Pallas arena kernels in interpret mode
(``impl="pallas"``) and its jnp path (``impl="jnp"``). Tolerances, and why,
are in PERF.md."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import _pallas_mt as jk
from beforeholiday_tpu.ops import arena as jarena
from beforeholiday_tpu.ops import multi_tensor as jmt
from beforeholiday_tpu.optimizers import FusedLAMB as JFusedLAMB
from beforeholiday_tpu.optimizers import MasterWeights as JMasterWeights
from beforeholiday_tpu_torch.ops import arena as tarena
from beforeholiday_tpu_torch.ops import multi_tensor as tmt
from beforeholiday_tpu_torch.optimizers import FusedLAMB as TFusedLAMB
from beforeholiday_tpu_torch.optimizers import FusedMixedPrecisionLamb
from beforeholiday_tpu_torch.optimizers import MasterWeights as TMasterWeights
from beforeholiday_tpu_torch.testing import gpt as tgpt

JAX_IMPLS = ["pallas", "jnp"]
SHAPES = [(3, 5), (7,), (2, 3, 4), (1000,), (40, 50)]
# the port rounds 1 - beta2 to fp32 once, as JAX's jnp path does; JAX's
# Pallas kernel forms it from an fp32 beta2 in-kernel (4.7e-5 apart)
RTOL = {"jnp": 1e-6, "pallas": 5e-5}
ATOL = 1e-7


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _lists(seed=0, shapes=SHAPES):
    """Seeded grads, params, first and second moments (v >= 0)."""
    rng = np.random.default_rng(seed)
    out = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
           for _ in range(4)]
    out[2] = [0.1 * a for a in out[2]]
    out[3] = [0.01 * np.abs(a) for a in out[3]]
    return out


def _flat(arrays):
    """The same arena in both packages."""
    jflat, jspec = jarena.flatten([jnp.asarray(a) for a in arrays])
    tflat, tspec = tarena.flatten([torch.from_numpy(a.copy()) for a in arrays])
    return jflat, jspec, tflat, tspec


# ------------------------------------------------------------ K9 and norms


@pytest.mark.parametrize("poison", [None, np.inf, np.nan])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_l2norm_sq_matches_jax_pallas(poison, dtype):
    """The sum of squares and the flag of JAX's Pallas ``l2norm_sq``."""
    xs = _lists(1)[0]
    if poison is not None:
        xs[3][17] = poison
    xs = [x.astype(dtype) for x in xs]
    jflat, _ = jarena.flatten([jnp.asarray(x) for x in xs])
    ref, rflag = jk.l2norm_sq(jflat, interpret=True)
    got, flag = tmt.l2norm_sq(tgpt._tensor(np.asarray(jflat), "cpu"))
    assert got.dtype == torch.float32 and got.shape == ()
    assert bool(flag) == bool(rflag) == (poison is not None)
    if poison is None:
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    else:
        assert not np.isfinite(got.item()) and not np.isfinite(float(ref))


def test_l2norm_sq_folds_the_scale_as_master_weights_does():
    """``scale`` multiplies each element before the square: JAX's
    ``MasterWeights._global_norm_extra`` formula."""
    x = _lists(2)[0][4].reshape(-1)
    ref = jnp.sum((jnp.asarray(x) * jnp.float32(1 / 1024)) ** 2)
    got, flag = tmt.l2norm_sq(torch.from_numpy(x), scale=torch.tensor(1 / 1024))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    assert not bool(flag)


@pytest.mark.parametrize("per_tensor", [False, True])
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_multi_tensor_l2norm_matches_jax(per_tensor, jax_impl):
    xs = _lists(3)[0]
    ref, ref_pt = jmt.multi_tensor_l2norm([jnp.asarray(x) for x in xs],
                                          per_tensor=per_tensor, impl=jax_impl)
    got, got_pt = tmt.multi_tensor_l2norm([torch.from_numpy(x) for x in xs],
                                          per_tensor=per_tensor)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    if per_tensor:
        assert got_pt.shape == (len(xs),)
        np.testing.assert_allclose(got_pt.numpy(), np.asarray(ref_pt), rtol=1e-6)
    else:
        assert got_pt is None and ref_pt is None


def test_per_tensor_sumsq_and_segment_coef_match_jax():
    jflat, jspec, tflat, tspec = _flat(_lists(4)[0])
    np.testing.assert_allclose(tmt.per_tensor_sumsq(tflat, tspec).numpy(),
                               np.asarray(jmt.per_tensor_sumsq(jflat, jspec)),
                               rtol=1e-6)
    vals = np.arange(1, len(SHAPES) + 1, dtype=np.float32)
    np.testing.assert_array_equal(
        tmt._segment_coef(torch.from_numpy(vals), tspec).numpy(),
        np.asarray(jmt._segment_coef(jnp.asarray(vals), jspec)))


# ------------------------------------------------------------ lamb_flat


# name -> (lamb_flat kwargs, what the case exercises)
LAMB_CASES = {
    "adamw_clip": dict(mode=1, weight_decay=0.01, max_grad_norm=1.0),
    "adamw_no_clip": dict(mode=1, weight_decay=0.01, max_grad_norm=1e4),
    "l2_clip": dict(mode=0, weight_decay=0.01, max_grad_norm=1.0),
    "no_decay": dict(mode=1, weight_decay=0.0, max_grad_norm=1.0),
    "no_decay_nvlamb": dict(mode=1, weight_decay=0.0, use_nvlamb=True,
                            max_grad_norm=1.0),
    "found_inf": dict(mode=1, weight_decay=0.01, max_grad_norm=1.0),
    "zero_norm": dict(mode=0, weight_decay=0.01, max_grad_norm=1.0),
}


def _lamb_inputs(case):
    g, p, m, v = _lists(5)
    if case == "found_inf":
        g[1][2] = np.inf
    if case == "zero_norm":
        # a tensor whose p is all zero (p_norm 0) and one whose update is
        # zero (g, m, v, p all zero: u_norm 0): the ratio falls back to lr
        p[0][:] = 0.0
        for a in (g, p, m, v):
            a[2][:] = 0.0
    return g, p, m, v


@pytest.mark.parametrize("case", list(LAMB_CASES))
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_lamb_flat_matches_jax(case, jax_impl):
    """p, m, v and the bf16 model copy after one step from the same state;
    the port updates p, m, v in place."""
    arrays = _lamb_inputs(case)
    flats = [_flat(a) for a in arrays]
    kw = dict(lr=2e-3, eps=1e-6, **LAMB_CASES[case])
    found = case == "found_inf"
    ref = jmt.lamb_flat(*(f[0] for f in flats), flats[0][1], step=jnp.int32(3),
                        found_inf=jnp.bool_(found) if found else None,
                        model_copy_dtype=jnp.bfloat16, impl=jax_impl, **kw)
    tg, tp, tm, tv = (f[2] for f in flats)
    p0, m0, v0 = tp.clone(), tm.clone(), tv.clone()
    got = tmt.lamb_flat(tg, tp, tm, tv, flats[0][3],
                        step=torch.tensor(3, dtype=torch.int32),
                        found_inf=torch.tensor(found) if found else None,
                        model_copy_dtype=torch.bfloat16, **kw)
    assert got[0] is tp and got[1] is tm and got[2] is tv
    if found:  # bitwise held in both packages
        for t, before, r in zip(got[:3], (p0, m0, v0), ref[:3]):
            assert torch.equal(t, before)
            np.testing.assert_array_equal(np.asarray(r), before.numpy())
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=RTOL[jax_impl], atol=ATOL)
    assert torch.equal(got[3], tp.to(torch.bfloat16))
    np.testing.assert_allclose(_np(got[3]), np.asarray(ref[3], np.float32),
                               rtol=2 ** -7, atol=0)
    # the padding of p stays 0
    assert torch.all(tp[flats[0][3].total:] == 0)


def test_lamb_flat_clips_by_a_given_global_norm():
    """A norm passed in (the all-arena norm) replaces the arena's own."""
    arrays = _lists(6)
    flats = [_flat(a) for a in arrays]
    kw = dict(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0)
    ref = jmt.lamb_flat(*(f[0] for f in flats), flats[0][1],
                        global_grad_norm=jnp.float32(500.0), impl="jnp", **kw)
    tg, tp, tm, tv = (f[2] for f in flats)
    tmt.lamb_flat(tg, tp, tm, tv, flats[0][3],
                  global_grad_norm=torch.tensor(500.0), **kw)
    for a, b in zip((tp, tm, tv), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_multi_tensor_lamb_matches_jax(jax_impl):
    lists = _lists(7)
    kw = dict(lr=1e-3, step=2, weight_decay=0.01)
    ref = jmt.multi_tensor_lamb(*[[jnp.asarray(a) for a in lst] for lst in lists],
                                impl=jax_impl, **kw)
    tl = [[torch.from_numpy(a.copy()) for a in lst] for lst in lists]
    got = tmt.multi_tensor_lamb(*tl, **kw)
    for gl, rl in zip(got, ref):
        for a, b in zip(gl, rl):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=RTOL[jax_impl], atol=ATOL)
    # the list API does not touch its inputs
    for a, b in zip(tl[1], lists[1]):
        np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------------------ optimizers


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "blocks": {"k": rng.standard_normal((2, 4, 3)).astype(np.float32)}}


def _torch_tree(tree):
    return tgpt.params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_fused_lamb_list_step_matches_jax(jax_impl):
    """Two steps of the list API with a folded grad scale: new params,
    moments and the step count."""
    params, grads = _tree(8), _tree(9)
    jopt = JFusedLAMB(lr=1e-2, weight_decay=0.01, impl=jax_impl)
    topt = TFusedLAMB(lr=1e-2, weight_decay=0.01)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch_tree(params)
    jo, to = jopt.init(jp), topt.init(tp)
    for _ in range(2):
        jp, jo = jopt.step(jp, jax.tree.map(jnp.asarray, grads), jo,
                           grad_scale=0.5)
        tp, to = topt.step(tp, _torch_tree(grads), to, grad_scale=0.5)
    assert int(to["step"]) == int(jo["step"]) == 2
    for tree_t, tree_j in ((tp, jp), (to["exp_avg"], jo["exp_avg"]),
                           (to["exp_avg_sq"], jo["exp_avg_sq"])):
        for a, b in zip(tarena.tree_flatten(tree_t)[0],
                        jax.tree_util.tree_leaves(tree_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=RTOL[jax_impl], atol=1e-6)


def _o5_tree(seed):
    """bf16 leaves and two fp32 norm leaves: two arenas under PackedParams."""
    tree = _tree(seed)
    tree["ln_scale"] = np.random.default_rng(seed).standard_normal(
        (7,)).astype(np.float32)
    cast = {k: (v if k.startswith("ln") else
                jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), v))
            for k, v in tree.items()}
    return cast


def _packed_step(jax_impl, max_grad_norm, split_norm=False):
    """One MasterWeights(FusedLAMB) step over a bf16 and an fp32 arena in
    both packages, the grads large enough to engage the clip. With
    ``split_norm`` the port clips each arena by its own norm instead."""
    params, grads = _o5_tree(10), _o5_tree(11)
    grads = jax.tree.map(lambda a: (np.asarray(a, np.float32) * 3).astype(a.dtype),
                         grads)
    jpk = jarena.PackedParams.pack(jax.tree.map(jnp.asarray, params))
    jg = jarena.PackedParams.pack(jax.tree.map(jnp.asarray, grads))
    jmw = JMasterWeights(JFusedLAMB(lr=1e-2, max_grad_norm=max_grad_norm,
                                    impl=jax_impl))
    jo = jmw.init(jpk)
    jpk, jo = jmw.step(jpk, jg, jo)
    tpk = tarena.PackedParams.pack(_torch_tree(params))
    tg = tarena.PackedParams.pack(_torch_tree(grads))
    tmw = TMasterWeights(TFusedLAMB(lr=1e-2, max_grad_norm=max_grad_norm))
    to = tmw.init(tpk)
    if split_norm:
        tmw._global_norm_extra = lambda flat_grads, grad_scale: {}
    tpk, to = tmw.step(tpk, tg, to)
    return (jpk, jo), (tpk, to)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_master_weights_lamb_shares_one_global_norm(jax_impl):
    """Masters, moments and both model arenas match JAX, whose
    ``_global_norm_extra`` clips both arenas by one norm; clipping each arena
    by its own norm moves the masters away from JAX."""
    (jpk, jo), (tpk, to) = _packed_step(jax_impl, max_grad_norm=1.0)
    assert [a.dtype for a in tpk.arenas] == [torch.bfloat16, torch.float32]
    for b in range(2):
        np.testing.assert_allclose(to["master"][b].numpy(),
                                   np.asarray(jo["master"][b]),
                                   rtol=RTOL[jax_impl], atol=1e-6)
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(to["inner"][b][key].numpy(),
                                       np.asarray(jo["inner"][b][key]),
                                       rtol=RTOL[jax_impl], atol=1e-7)
        assert int(to["inner"][b]["step"]) == 1
        assert torch.equal(tpk.arenas[b], to["master"][b].to(tpk.arenas[b].dtype))
        np.testing.assert_allclose(_np(tpk.arenas[b]),
                                   np.asarray(jpk.arenas[b], np.float32),
                                   rtol=2 ** -7, atol=0)
    _, (_, split) = _packed_step(jax_impl, max_grad_norm=1.0, split_norm=True)
    moved = max(float(np.abs(split["inner"][b]["exp_avg"].numpy()
                             - np.asarray(jo["inner"][b]["exp_avg"])).max())
                for b in range(2))
    assert moved > 1e-4


def test_fused_mixed_precision_lamb_is_master_weights_of_lamb():
    """The tree path: fp32 masters, the model copy in each leaf's dtype, and
    the same result as MasterWeights(FusedLAMB)."""
    params = _torch_tree(_tree(12))
    params["w"] = params["w"].to(torch.bfloat16)
    grads = tarena.tree_map(lambda p: torch.ones_like(p) * 0.1, params)
    fmp = FusedMixedPrecisionLamb(lr=1e-2)
    mw = TMasterWeights(TFusedLAMB(lr=1e-2))
    outs = []
    for opt in (fmp, mw):
        st = opt.init(params)
        outs.append(opt.step(params, grads, st))
    assert fmp.lr == 1e-2 and fmp.inner.adam_w_mode
    (p1, s1), (p2, s2) = outs
    assert p1["w"].dtype == torch.bfloat16 and s1["master"]["w"].dtype == torch.float32
    for a, b in zip(tarena.tree_flatten(p1)[0], tarena.tree_flatten(p2)[0]):
        assert torch.equal(a, b)


def test_fused_lamb_step_flat_needs_the_spec():
    opt = TFusedLAMB()
    flat = torch.zeros(tarena.TILE)
    with pytest.raises(ValueError):
        opt.step_flat(flat, flat, opt.init_flat(flat))


def test_kernel_wrappers_refuse_cpu_tensors():
    """K7, K8 and K9 launch on CUDA tensors or raise; they never fall back."""
    x = torch.zeros(8)
    spec = tarena.make_spec([(8,)])
    with pytest.raises(ValueError):
        tmt.l2norm_sq_kernel(x)
    with pytest.raises(ValueError):
        tmt.lamb_stage1_kernel(x, x, x, x, beta1=0.9, beta2=0.999, beta3=0.1,
                               bc1=1.0, bc2=1.0, eps=1e-6, weight_decay=0.0,
                               clip=1.0, mode=1, found_inf=None)
    with pytest.raises(ValueError):
        tmt.scaled_update_kernel(x, x, torch.ones(1), spec, found_inf=None,
                                 copy_out=None)
    with pytest.raises(ValueError):
        tmt.l2norm_sq(x, impl="kernel")
