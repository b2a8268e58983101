"""Port parity: flat arenas, ``PackedParams``, ``multi_tensor_scale`` (kernel
K5's plain path), ``adam_flat``/``multi_tensor_adam`` (kernel K6's plain
path) and ``multi_tensor_axpby`` (kernel K16's plain path), held against the JAX package on the same numpy inputs. The JAX side
runs its Pallas arena kernels in interpret mode (``impl="pallas"``) and its
jnp path (``impl="jnp"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import arena as jarena
from beforeholiday_tpu.ops import multi_tensor as jmt
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch.ops import arena as tarena
from beforeholiday_tpu_torch.ops import multi_tensor as tmt
from beforeholiday_tpu_torch.testing import gpt as tgpt

JAX_IMPLS = ["pallas", "jnp"]
SHAPES = [(3, 5), (7,), (2, 3, 4), (1000,)]


def _tensors(shapes, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------- arenas


@pytest.mark.parametrize("shapes", [SHAPES, [(32768,)], [(5,)], [(256, 128), (3,)]])
def test_spec_and_flatten_match_jax(shapes):
    xs = _tensors(shapes)
    jflat, jspec = jarena.flatten([jnp.asarray(x) for x in xs])
    tflat, tspec = tarena.flatten([torch.from_numpy(x) for x in xs])
    assert (tspec.shapes, tspec.offsets, tspec.total, tspec.padded_total) == (
        jspec.shapes, jspec.offsets, jspec.total, jspec.padded_total)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    for got, ref in zip(tarena.unflatten(tflat, tspec),
                        jarena.unflatten(jflat, jspec)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    again = tarena.views_to_arena(tarena.unflatten(tflat, tspec), tspec)
    assert torch.equal(again, tflat)


def test_unflatten_pieces_are_views():
    flat, spec = tarena.flatten([torch.zeros(3, 2), torch.zeros(4)])
    a, b = tarena.unflatten(flat, spec)
    a.fill_(1.0)
    b.fill_(2.0)
    assert flat[:6].eq(1).all() and flat[6:10].eq(2).all() and flat[10:].eq(0).all()


def test_flatten_rejects_mixed_dtypes():
    with pytest.raises(ValueError):
        tarena.flatten([torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)])


def _o5_tree(cfg_kw):
    jcfg = jgpt.GPTConfig(**cfg_kw)
    params = jgpt.init(jax.random.PRNGKey(0), jcfg)
    cast = jax.tree_util.tree_map_with_path(
        lambda p, a: a if "ln" in jax.tree_util.keystr(p) else a.astype(jnp.bfloat16),
        params)
    return cast, jax.tree.map(np.asarray, cast)


@pytest.mark.parametrize("cfg_kw", [
    dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4, n_layers=2),
    dict(vocab_size=100, seq_len=16, d_model=48, n_heads=3, n_layers=3),
])
def test_packed_params_match_jax(cfg_kw):
    """Same buckets (sorted by dtype name), leaf indices, offsets and
    padding, and arenas equal bit for bit; unpack returns the leaves."""
    jtree, np_tree = _o5_tree(cfg_kw)
    jp = jarena.PackedParams.pack(jtree)
    tp = tarena.PackedParams.pack(tgpt.params_from_numpy(np_tree, device="cpu"))
    assert [str(d).replace("torch.", "") for d in tp.layout.dtypes] == [
        d.name for d in jp.layout.dtypes]
    assert tp.layout.indices == jp.layout.indices
    for ts, js in zip(tp.layout.specs, jp.layout.specs):
        assert (ts.shapes, ts.offsets, ts.total, ts.padded_total) == (
            js.shapes, js.offsets, js.total, js.padded_total)
    for ta, ja in zip(tp.arenas, jp.arenas):
        np.testing.assert_array_equal(_np(ta), np.asarray(ja, np.float32))
    tleaves = tarena.tree_flatten(tp.unpack())[0]
    jleaves = jax.tree_util.tree_leaves(jp.unpack())
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))


def test_tree_flatten_order_matches_jax():
    tree = {"b": {"y": 1, "x": [2, 3]}, "a": (4, {"z": 5})}
    leaves, treedef = tarena.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert tarena.tree_unflatten(treedef, leaves) == tree
    assert tarena.tree_paths(tree)[0] == ("a", 0)


def test_bucket_by_dtype_rejects_integer_leaves():
    with pytest.raises(ValueError):
        tarena.bucket_by_dtype([torch.zeros(2), torch.zeros(2, dtype=torch.int32)])


def test_replace_arenas_checks_the_count():
    p = tarena.PackedParams.pack({"w": torch.zeros(4)})
    with pytest.raises(ValueError):
        p.replace_arenas([])


# --------------------------------------------------- multi_tensor_scale (K5)


CASES = {
    "clean": None,
    "inf": (0, 3, np.inf),
    "nan": (1, 2, np.nan),
    "neg_inf": (3, 999, -np.inf),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_multi_tensor_scale_matches_jax(case, dtype, jax_impl):
    """Bitwise values and the same flag."""
    xs = _tensors(SHAPES, seed=3)
    if CASES[case] is not None:
        i, j, val = CASES[case]
        xs[i].reshape(-1)[j] = val
    xs = [x.astype(dtype) for x in xs]
    ref, rflag = jmt.multi_tensor_scale([jnp.asarray(x) for x in xs], 0.125,
                                        out_dtype=jnp.float32, impl=jax_impl)
    tx = [tgpt._tensor(x, "cpu") for x in xs]
    got, flag = tmt.multi_tensor_scale(tx, torch.tensor(0.125),
                                       out_dtype=torch.float32)
    assert bool(flag) == bool(rflag) == (CASES[case] is not None)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_multi_tensor_scale_flags_overflowing_output(jax_impl):
    xs = [np.full((10,), 3e38, np.float32)]
    _, rflag = jmt.multi_tensor_scale([jnp.asarray(xs[0])], 2.0, impl=jax_impl)
    _, flag = tmt.multi_tensor_scale([torch.from_numpy(xs[0])], 2.0)
    assert bool(flag) and bool(rflag)


def test_multi_tensor_scale_uses_an_arena_as_is():
    arena = torch.randn(tarena.TILE)
    (out,), flag = tmt.multi_tensor_scale([arena], 2.0)
    assert out.shape == arena.shape and not bool(flag)
    assert torch.equal(out, arena * 2.0)


# ---------------------------------------------------------- adam_flat (K6)


def _adam_inputs(n=3 * 1000 + 7, seed=4):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    m = (0.1 * rng.standard_normal(n)).astype(np.float32)
    v = (0.01 * rng.random(n)).astype(np.float32)
    return g, p, m, v


ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
            grad_scale=0.5)
# the port (kernel and plain version alike) rounds 1 - beta to fp32 once, as
# JAX's jnp path does; JAX's Pallas kernel forms 1 - beta from fp32 betas
# in-kernel, 1 - fp32(0.999) being 4.7e-5 away from fp32(0.001) relatively
ADAM_RTOL = {"jnp": 1e-6, "pallas": 5e-5}


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_adam_flat_matches_jax(adam_w_mode, bias_correction, jax_impl):
    """Both modes, bias correction on and off, a device step count, the bf16
    model copy: rtol 1e-6; the port updates p, m, v in place."""
    g, p, m, v = _adam_inputs()
    kw = dict(ADAM, adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    ref = jmt.adam_flat(*(jnp.asarray(a) for a in (g, p, m, v)), step=jnp.int32(3),
                        model_copy_dtype=jnp.bfloat16, impl=jax_impl, **kw)
    tg, tp, tm, tv = (torch.from_numpy(a.copy()) for a in (g, p, m, v))
    got = tmt.adam_flat(tg, tp, tm, tv, step=torch.tensor(3, dtype=torch.int32),
                        model_copy_dtype=torch.bfloat16, **kw)
    assert got[0] is tp and got[1] is tm and got[2] is tv
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=ADAM_RTOL[jax_impl], atol=1e-7)
    assert torch.equal(got[3], tp.to(torch.bfloat16))
    # the copy rounds the same fp32 value: one bf16 ulp at most
    np.testing.assert_allclose(_np(got[3]), np.asarray(ref[3], np.float32),
                               rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_adam_flat_skip_is_identity(jax_impl):
    g, p, m, v = _adam_inputs()
    ref = jmt.adam_flat(*(jnp.asarray(a) for a in (g, p, m, v)), step=2,
                        found_inf=jnp.bool_(True), impl=jax_impl, **ADAM)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    copy = torch.from_numpy(p).to(torch.bfloat16)
    before = copy.clone()
    tmt.adam_flat(torch.from_numpy(g), tp, tm, tv, step=2,
                  found_inf=torch.tensor(True), model_copy=copy, **ADAM)
    for t, a, r in zip((tp, tm, tv), (p, m, v), ref):
        np.testing.assert_array_equal(t.numpy(), a)
        np.testing.assert_array_equal(np.asarray(r), a)
    assert torch.equal(copy, before)


@pytest.mark.parametrize("step", [1, 5])
def test_bias_corrections_match_jax(step):
    got = tmt._bias_corrections(True, torch.tensor(step, dtype=torch.int32),
                                0.9, 0.999)
    ref = jmt._bias_corrections(True, jnp.int32(step), 0.9, 0.999)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
    assert tmt._bias_corrections(False, step, 0.9, 0.999) == (1.0, 1.0)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_multi_tensor_adam_matches_jax(jax_impl):
    rng = np.random.default_rng(9)
    lists = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(4)]
    lists[3] = [np.abs(a) * 0.01 for a in lists[3]]
    ref = jmt.multi_tensor_adam(*[[jnp.asarray(a) for a in lst] for lst in lists],
                                lr=1e-3, step=2, weight_decay=0.1, impl=jax_impl)
    tl = [[torch.from_numpy(a.copy()) for a in lst] for lst in lists]
    got = tmt.multi_tensor_adam(*tl, lr=1e-3, step=2, weight_decay=0.1)
    for gl, rl in zip(got, ref):
        for a, b in zip(gl, rl):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=ADAM_RTOL[jax_impl], atol=1e-7)
    # the list API does not touch its inputs
    for a, b in zip(tl[1], lists[1]):
        np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------- multi_tensor_axpby (K16)


AXPBY_POISON = {  # case -> (list, tensor, element, value)
    "clean": None,
    "nan_in_x": (0, 1, 2, np.nan),
    "inf_in_y": (1, 3, 999, np.inf),
}


@pytest.mark.parametrize("case", list(AXPBY_POISON))
@pytest.mark.parametrize("arg_to_check", [-1, 0, 1])
@pytest.mark.parametrize("dtype, out_dtype", [
    (np.float32, None), (jnp.bfloat16, None), (jnp.bfloat16, "float32"),
    (np.float32, "bfloat16")])
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_multi_tensor_axpby_matches_jax(case, arg_to_check, dtype, out_dtype,
                                        jax_impl):
    """out = a x + b y in fp32, stored in out_dtype: fp32 outputs within
    rtol 1e-6 (a multiply-add may round once or twice), half outputs the
    same fp32 value rounded once (one ulp); the same flag for each
    ``arg_to_check``."""
    xs = [_tensors(SHAPES, seed=s) for s in (11, 12)]
    poison = AXPBY_POISON[case]
    if poison is not None:
        lst, i, j, val = poison
        xs[lst][i].reshape(-1)[j] = val
    xs = [[x.astype(dtype) for x in lst] for lst in xs]
    jout_dt = None if out_dtype is None else getattr(jnp, out_dtype)
    tout_dt = None if out_dtype is None else getattr(torch, out_dtype)
    ref, rflag = jmt.multi_tensor_axpby(
        *[[jnp.asarray(x) for x in lst] for lst in xs], 0.75, -1.5,
        out_dtype=jout_dt, arg_to_check=arg_to_check, impl=jax_impl)
    got, flag = tmt.multi_tensor_axpby(
        *[[tgpt._tensor(x, "cpu") for x in lst] for lst in xs], 0.75,
        torch.tensor(-1.5), out_dtype=tout_dt, arg_to_check=arg_to_check)
    expect = poison is not None and arg_to_check in (-1, poison[0])
    assert bool(flag) == bool(rflag) == expect
    rtol = 1e-6 if got[0].dtype == torch.float32 else 2 ** -7
    for g, r in zip(got, ref):
        assert g.dtype == (tout_dt or tgpt._tensor(xs[0][0], "cpu").dtype)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), np.asarray(r, np.float32), rtol=rtol,
                                   atol=1e-6, equal_nan=True)


def test_multi_tensor_axpby_uses_arenas_as_they_are():
    """A gradient arena pair goes in without a flatten copy: one output of
    the arena's length, the padding 0."""
    x, y = torch.randn(tarena.TILE), torch.randn(tarena.TILE)
    x[-5:] = 0
    y[-5:] = 0
    (out,), flag = tmt.multi_tensor_axpby([x], [y], 0.5, 0.5, arg_to_check=0)
    assert out.shape == x.shape and not bool(flag)
    assert torch.equal(out, 0.5 * x + 0.5 * y) and not out[-5:].any()


def test_kernel_wrappers_refuse_cpu_tensors():
    """K5, K6 and K16 launch on CUDA tensors or raise; they never fall
    back."""
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        tmt.scale_kernel(x, 1.0, torch.float32)
    with pytest.raises(ValueError):
        tmt.adam_kernel(x, x, x, x, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                        bc1=1.0, bc2=1.0, weight_decay=0.0, adam_w_mode=True,
                        grad_scale=1.0, found_inf=None, copy_out=None)
    with pytest.raises(ValueError):
        tmt.multi_tensor_scale([x], 1.0, impl="kernel")
    with pytest.raises(ValueError):
        tmt.axpby_kernel(x, x, 1.0, 1.0, torch.float32)
    with pytest.raises(ValueError):
        tmt.multi_tensor_axpby([x], [x], 1.0, 1.0, impl="kernel")
