"""Port parity: the optimizer-in-backward step (``parallel/overlap.py``'s
``per_bucket_found_inf`` and ``fold_found_inf``,
``optimizers/fused.py``'s ``step_in_backward``, the view path
``_step_views`` of ``FusedAdam`` and ``FusedSGD``, ``MasterWeights
.step_in_backward``) and the views mode of K6 and K10
(``ops/multi_tensor.py``), against the JAX package, the counterpart of
``tests/test_overlap_engine.py``'s optimizer-in-backward class.

* The per-bucket flags and their fold against JAX's on the same leaves
  (NaN, inf, bf16 and integer leaves, the scaler's sentinel).
* ``step_in_backward`` in a spawned gloo world of 2 (hooked backward on a
  3-layer MLP) against JAX's ``shard_map`` step over 2 host devices at
  JAX's ZeRO-class bound (rtol 1e-4, atol 1e-5), and bitwise the port's
  phased step (``reduce_gradients`` then the view path) and the arena step
  on the packed grads; LAMB's view path raises with a pointer to
  ``ROADMAP.md``.
* The whole-step skip: one poisoned leaf at ``bucket_bytes=128`` holds the
  arena, both moments and the count; clean leaves commit every bucket.
* The view path of Adam (AdamW and L2) and SGD (momentum, Nesterov,
  dampening, weight decay after momentum) against JAX's on the same leaf
  list for 3 steps, with the step-1 momentum seed; bitwise the port's arena
  path; the model copy written in the same pass.
* The views-mode plain versions bitwise the arena plain versions, the
  tail padding untouched, ``found_inf`` holding everything.
* ``MasterWeights.step_in_backward`` over an O5-style PackedParams (bf16 and
  fp32 arenas, a stacked leaf) bitwise the packed phased step, from packed
  grads, tree grads and tree grads with the stacked leaf's per-layer
  pieces; one poisoned fp32 leaf holds both arenas.
* ``StepGuard.apply_update(extra_found_inf=)`` skips and backs the scale
  off, as JAX's guard does.
* The refusals: ``state_dtype`` other than fp32, ``MasterWeights(arena=
  True)``, LAMB's view path.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu.ops import arena as jarena  # noqa: E402
from beforeholiday_tpu.optimizers import (  # noqa: E402
    FusedAdam as JAdam,
    FusedLAMB as JLAMB,
    FusedSGD as JSGD,
)
from beforeholiday_tpu.parallel import overlap as joverlap  # noqa: E402
from beforeholiday_tpu_torch.ops import multi_tensor as tmt  # noqa: E402
from beforeholiday_tpu_torch.ops.arena import PackedParams, flatten  # noqa: E402
from beforeholiday_tpu_torch.optimizers import (  # noqa: E402
    FusedAdam,
    FusedLAMB,
    FusedSGD,
    MasterWeights,
)
from beforeholiday_tpu_torch.parallel import overlap  # noqa: E402

_shard_map = getattr(jax, "shard_map", None)
_CHECK_KW = "check_vma"
if _shard_map is None:
    from jax.experimental.shard_map import shard_map as _shard_map

    _CHECK_KW = "check_rep"


def shard_map(f=None, **kw):
    kw.setdefault(_CHECK_KW, False)
    if f is None:
        return lambda g: _shard_map(g, **kw)
    return _shard_map(f, **kw)


WORLD, DIM = 2, 8
TOL = dict(rtol=1e-4, atol=1e-5)
OPTS = {"adam": ("adam", dict(lr=1e-3)),
        "sgd": ("sgd", dict(lr=1e-2, momentum=0.9)),
        "lamb": ("lamb", dict(lr=1e-3))}
JOPTS = {"adam": lambda: JAdam(lr=1e-3), "sgd": lambda: JSGD(lr=1e-2, momentum=0.9)}


def _mlp_leaves(rng, dim=DIM, layers=3):
    leaves = []
    for _ in range(layers):
        leaves.append((rng.randn(dim, dim) * 0.3).astype(np.float32))
        leaves.append(np.zeros((dim,), np.float32))
    return leaves


def _leaves_loss(leaves, x, tgt):
    h = x
    for i in range(len(leaves) // 2):
        h = jnp.tanh(h @ leaves[2 * i] + leaves[2 * i + 1])
    return jnp.mean((h - tgt) ** 2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ the flags and the fold


def _flag_cases():
    ones = [np.ones((64,), np.float32) for _ in range(4)]
    nan = [a.copy() for a in ones]
    nan[2][5] = np.nan
    inf = [a.copy() for a in ones]
    inf[0][0] = -np.inf
    return {"nan": (nan, 256), "inf": (inf, 256), "clean": (ones, 256),
            "one_bucket": (nan, None), "pairs": (inf, 512)}


@pytest.mark.parametrize("case", list(_flag_cases()))
def test_per_bucket_flags_match_jax(case):
    leaves, bb = _flag_cases()[case]
    got = [bool(f) for f in overlap.per_bucket_found_inf([_t(a) for a in leaves],
                                                         bucket_bytes=bb)]
    want = [bool(np.asarray(f)) for f in joverlap.per_bucket_found_inf(
        [jnp.asarray(a) for a in leaves], bucket_bytes=bb)]
    assert got == want
    for ext in (None, True, False):
        f_got = overlap.fold_found_inf(overlap.per_bucket_found_inf(
            [_t(a) for a in leaves], bucket_bytes=bb), ext)
        f_want = joverlap.fold_found_inf(joverlap.per_bucket_found_inf(
            [jnp.asarray(a) for a in leaves], bucket_bytes=bb), ext)
        assert bool(f_got) == bool(np.asarray(f_want))
        assert f_got.dtype == torch.bool and f_got.shape == ()


def test_flags_of_mixed_dtypes():
    """bf16 leaves are checked as they are; integer leaves cannot overflow;
    the buckets are dtype-uniform (partition_leaves)."""
    leaves = [torch.ones(64, dtype=torch.bfloat16), torch.arange(64),
              torch.ones(64)]
    leaves[0][3] = float("inf")
    flags = overlap.per_bucket_found_inf(leaves, bucket_bytes=None)
    want = joverlap.per_bucket_found_inf(
        [jnp.ones((64,), jnp.bfloat16).at[3].set(jnp.inf), jnp.arange(64),
         jnp.ones((64,))], bucket_bytes=None)
    assert [bool(f) for f in flags] == [bool(np.asarray(f)) for f in want]
    assert not bool(overlap.fold_found_inf([]))


# ------------------------------------------- step_in_backward in a DP world


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    rng = np.random.RandomState(2)
    leaves = _mlp_leaves(rng)
    x = rng.randn(WORLD, 4, DIM).astype(np.float32)
    tgt = rng.randn(WORLD, 4, DIM).astype(np.float32)
    res = tw.run_world(tw.step_in_backward_scenario, WORLD,
                       tmp_path_factory.mktemp("oib"), leaves, x, tgt, OPTS,
                       timeout=300)
    return leaves, x, tgt, res


def _jax_hook_step(name, leaves, x, tgt):
    devs = jax.devices()[:WORLD]
    mesh = Mesh(np.asarray(devs), ("data",))
    flat, spec = jarena.flatten([jnp.asarray(a) for a in leaves])
    opt = JOPTS[name]()
    state0 = opt.init_flat(flat)

    @jax.jit
    @shard_map(mesh=mesh, in_specs=(P(), P(), P("data"), P("data")),
               out_specs=(P(), P(), P()))
    def hook_step(flat, state, x, tgt):
        pieces = jarena.unflatten(flat, spec)
        _, g = jax.value_and_grad(lambda lv: _leaves_loss(
            joverlap.hook_tree(list(lv), tag="oib", axis_name="data"), x, tgt))(pieces)
        return opt.step_in_backward(flat, list(g), state, spec=spec)

    return jax.device_get(hook_step(flat, state0, jnp.asarray(x), jnp.asarray(tgt)))


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_step_in_backward_matches_jax(dp_world, name):
    leaves, x, tgt, res = dp_world
    flat, state, flag = _jax_hook_step(name, leaves, x, tgt)
    assert not bool(np.asarray(flag))
    for r in res:
        got = r[name]
        assert got["flag"] is False
        np.testing.assert_allclose(got["hooked"]["flat"], np.asarray(flat), **TOL)
        for k, v in state.items():
            np.testing.assert_allclose(got["hooked"]["state"][k], np.asarray(v), **TOL)


@pytest.mark.parametrize("name", ["adam", "sgd"])
@pytest.mark.parametrize("ref", ["phased", "arena"])
def test_step_in_backward_bitwise_phased(dp_world, name, ref):
    """The hooked backward plus step_in_backward is bitwise the post-backward
    reduce plus the view path (and the arena step on the packed grads)."""
    for r in dp_world[3]:
        got, want = r[name]["hooked"], r[name][ref]
        assert np.array_equal(got["flat"], want["flat"])
        for k in want["state"]:
            assert np.array_equal(got["state"][k], want["state"][k]), k


def test_lamb_view_path_points_at_roadmap(dp_world):
    for r in dp_world[3]:
        lamb = r["lamb"]
        assert "ROADMAP.md" in lamb["hooked"] and "ROADMAP.md" in lamb["phased"]
        assert isinstance(lamb["arena"], dict)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FusedLAMB(lr=1e-3).step_flat(torch.zeros(32768), [torch.ones(3)],
                                     FusedLAMB().init_flat(torch.zeros(32768)))
    # JAX's LAMB has the view path the port still lacks
    assert hasattr(JLAMB, "_step_views")


# ------------------------------------------------------------- whole-step skip


def _flat_setup(rng):
    leaves = [_t(a) for a in _mlp_leaves(rng)]
    flat, spec = flatten(leaves)
    return leaves, flat, spec


def test_overflow_skips_the_whole_step():
    rng = np.random.RandomState(3)
    opt = FusedAdam(lr=1e-3)
    leaves, flat, spec = _flat_setup(rng)
    state = opt.init_flat(flat)
    before = (flat.clone(), state["exp_avg"].clone(), state["exp_avg_sq"].clone())
    grads = [torch.full(l.shape, 1e-3) for l in leaves]
    grads[-1][0] = float("inf")  # the LAST leaf; bucket_bytes=128 splits many
    assert len(overlap.per_bucket_found_inf(grads, bucket_bytes=128)) > 3
    flat, state, flag = opt.step_in_backward(flat, grads, state, spec=spec,
                                             bucket_bytes=128)
    assert bool(flag)
    assert torch.equal(flat, before[0]) and int(state["step"]) == 0
    assert torch.equal(state["exp_avg"], before[1])
    assert torch.equal(state["exp_avg_sq"], before[2])
    clean = [torch.full(l.shape, 1e-3) for l in leaves]
    flat2, state2, flag2 = opt.step_in_backward(flat.clone(), clean, state,
                                                spec=spec, bucket_bytes=128)
    assert not bool(flag2) and int(state2["step"]) == 1
    n = spec.total
    assert not torch.equal(flat2[:n], before[0][:n])


def test_overflow_matches_jax_whole_step_skip():
    rng = np.random.RandomState(3)
    leaves = _mlp_leaves(rng)
    grads = [np.full(l.shape, 1e-3, np.float32) for l in leaves]
    grads[-1].reshape(-1)[0] = np.inf
    jflat, jspec = jarena.flatten([jnp.asarray(a) for a in leaves])
    jopt = JAdam(lr=1e-3)
    jst = jopt.init_flat(jflat)
    jf, js, jflag = jopt.step_in_backward(jflat, [jnp.asarray(g) for g in grads], jst,
                                          spec=jspec, bucket_bytes=128)
    opt = FusedAdam(lr=1e-3)
    flat, spec = flatten([_t(a) for a in leaves])
    f, s, flag = opt.step_in_backward(flat, [_t(g) for g in grads], opt.init_flat(flat),
                                      spec=spec, bucket_bytes=128)
    assert bool(flag) == bool(np.asarray(jflag))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert int(s["step"]) == int(js["step"])


# ----------------------------------------------------------- the view path


VIEW_OPTS = {
    "adamw": (lambda: FusedAdam(lr=1e-2, weight_decay=0.02),
              lambda: JAdam(lr=1e-2, weight_decay=0.02)),
    "adam_l2": (lambda: FusedAdam(lr=1e-2, weight_decay=0.02, adam_w_mode=False),
                lambda: JAdam(lr=1e-2, weight_decay=0.02, adam_w_mode=False)),
    "sgd_momentum": (lambda: FusedSGD(1e-2, 0.9, weight_decay=1e-4),
                     lambda: JSGD(1e-2, 0.9, weight_decay=1e-4)),
    "sgd_nesterov": (lambda: FusedSGD(1e-2, 0.9, nesterov=True),
                     lambda: JSGD(1e-2, 0.9, nesterov=True)),
    "sgd_dampening": (lambda: FusedSGD(1e-2, 0.9, 0.1, wd_after_momentum=True,
                                       weight_decay=1e-3),
                      lambda: JSGD(1e-2, 0.9, 0.1, wd_after_momentum=True,
                                   weight_decay=1e-3)),
    "sgd_plain": (lambda: FusedSGD(1e-2), lambda: JSGD(1e-2)),
}


def _view_data(seed, steps=3):
    rng = np.random.RandomState(seed)
    leaves = _mlp_leaves(rng)
    return leaves, [[rng.randn(*l.shape).astype(np.float32) for l in leaves]
                    for _ in range(steps)]


@pytest.mark.parametrize("name", list(VIEW_OPTS))
def test_view_path_matches_jax(name):
    make, jmake = VIEW_OPTS[name]
    leaves, gseq = _view_data(5)
    opt, jopt = make(), jmake()
    flat, spec = flatten([_t(a) for a in leaves])
    state = opt.init_flat(flat)
    jflat, jspec = jarena.flatten([jnp.asarray(a) for a in leaves])
    jstate = jopt.init_flat(jflat)
    for g in gseq:
        flat, state = opt.step_flat(flat, [_t(a) for a in g], state, spec=spec,
                                    grad_scale=0.5)
        jflat, jstate = jopt.step_flat(jflat, [jnp.asarray(a) for a in g], jstate,
                                       spec=jspec, grad_scale=0.5)
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=1e-6, atol=1e-7)
    for k, v in jstate.items():
        np.testing.assert_allclose(state[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name", list(VIEW_OPTS))
def test_view_path_bitwise_arena_path(name):
    make, _ = VIEW_OPTS[name]
    leaves, gseq = _view_data(6)
    outs = []
    for views in (True, False):
        opt = make()
        flat, spec = flatten([_t(a) for a in leaves])
        state = opt.init_flat(flat)
        copy = torch.zeros(flat.shape, dtype=torch.bfloat16)
        for g in gseq:
            g = [_t(a) for a in g]
            flat, state, copy = opt.step_flat(
                flat, g if views else flatten(g)[0], state, spec=spec,
                model_copy=copy)
        outs.append((flat, state, copy))
    (f1, s1, c1), (f2, s2, c2) = outs
    assert torch.equal(f1, f2) and torch.equal(c1, c2)
    assert torch.equal(c1, f1.to(torch.bfloat16))
    for k in s2:
        assert torch.equal(s1[k], s2[k]), k


# ------------------------------------------------- views-mode plain versions


def _views_setup(seed):
    rng = np.random.RandomState(seed)
    leaves = [_t(rng.randn(*s).astype(np.float32)) for s in ((37, 19), (128,), (5, 3, 7))]
    p, spec = flatten([_t(rng.randn(*l.shape).astype(np.float32)) for l in leaves])
    return leaves, p, spec


@pytest.mark.parametrize("found_inf", [None, 0, 1])
def test_adam_views_plain_bitwise_arena_plain(found_inf):
    leaves, p, spec = _views_setup(8)
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, bc1=0.1, bc2=0.001,
                 weight_decay=0.01, adam_w_mode=True, grad_scale=0.25,
                 found_inf=None if found_inf is None else torch.tensor(found_inf))
    runs = []
    for views in (True, False):
        pp, m, v = p.clone(), torch.full_like(p, 0.01), torch.full_like(p, 0.02)
        m[spec.total:] = 0
        v[spec.total:] = 0
        copy = torch.zeros(p.shape, dtype=torch.bfloat16)
        if views:
            tmt.adam_views_torch(leaves, pp, m, v, spec, copy_out=copy, **hyper)
        else:
            tmt.adam_torch(flatten(leaves)[0], pp, m, v, copy_out=copy, **hyper)
        runs.append((pp, m, v, copy))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    if found_inf:
        assert torch.equal(runs[0][0], p)


@pytest.mark.parametrize("first_run", [True, False])
def test_sgd_views_plain_bitwise_arena_plain(first_run):
    leaves, p, spec = _views_setup(9)
    hyper = dict(lr=1e-2, weight_decay=1e-4, momentum=0.9, dampening=0.0,
                 nesterov=True, first_run=torch.tensor(first_run),
                 wd_after_momentum=False, scale=0.5, found_inf=torch.tensor(0))
    runs = []
    for views in (True, False):
        pp, m = p.clone(), torch.full_like(p, 0.01)
        m[spec.total:] = 0
        copy = torch.zeros(p.shape, dtype=torch.bfloat16)
        if views:
            tmt.sgd_views_torch(leaves, pp, m, spec, copy_out=copy, **hyper)
        else:
            tmt.sgd_torch(flatten(leaves)[0], pp, m, copy_out=copy, **hyper)
        runs.append((pp, m, copy))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_views_wrappers_take_the_plain_version_on_the_cpu():
    leaves, p, spec = _views_setup(10)
    before = tmt.adam_views_kernel.launches
    tmt.adam_views(leaves, p, torch.zeros_like(p), torch.zeros_like(p), spec, lr=1e-3)
    tmt.sgd_views(leaves, p, torch.zeros_like(p), spec, lr=1e-3, momentum=0.9)
    assert tmt.adam_views_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tmt.adam_views(leaves, p, torch.zeros_like(p), torch.zeros_like(p), spec,
                       lr=1e-3, impl="kernel")
    with pytest.raises(ValueError, match="leaves"):
        tmt.adam_views_kernel(leaves[:2], p, p, p, spec, lr=1e-3, beta1=0.9,
                              beta2=0.9, eps=1e-8, bc1=1.0, bc2=1.0,
                              weight_decay=0.0, adam_w_mode=True, grad_scale=1.0,
                              found_inf=None, copy_out=None)


# ------------------------------------------------ MasterWeights, amp O5 form


def _o5_packed(seed):
    """An O5-style tree: bf16 leaves (one stacked under ``blocks``) and an
    fp32 norm leaf, and grads shaped like it."""
    rng = np.random.RandomState(seed)

    def draw():
        return {"blocks": {"wq": _t(rng.randn(3, 16, 8).astype(np.float32)
                                    ).to(torch.bfloat16)},
                "w": _t(rng.randn(64, 32).astype(np.float32)).to(torch.bfloat16),
                "b": _t(rng.randn(32).astype(np.float32)).to(torch.bfloat16),
                "ln": _t(rng.randn(32).astype(np.float32))}

    return draw(), draw()


@pytest.mark.parametrize("inner", ["adam", "sgd"])
@pytest.mark.parametrize("form", ["tree", "layers", "packed"])
def test_master_weights_step_in_backward_bitwise_packed_step(inner, form):
    """From packed grads, a tree of them, or a tree whose stacked leaf comes
    as its per-layer pieces (as ``grad_leaves`` hands the layers out)."""
    tree, grads = _o5_packed(11)
    outs = []
    for path in ("phased", "oib"):
        packed = PackedParams.pack({k: (v.clone() if k != "blocks" else dict(v))
                                    for k, v in tree.items()})
        mw = MasterWeights(FusedAdam(lr=1e-2, weight_decay=0.01) if inner == "adam"
                           else FusedSGD(1e-2, 0.9))
        state = mw.init(packed)
        gp = PackedParams.pack(grads)
        for _ in range(2):
            if path == "phased":
                g32 = gp.replace_arenas([a.float() * 0.5 for a in gp.arenas])
                packed, state = mw.step(packed, g32, state)
            else:
                g = {"packed": gp, "tree": grads,
                     "layers": {**grads, "blocks": {"wq": grads["blocks"]["wq"].unbind(0)}}
                     }[form]
                packed, state, flag = mw.step_in_backward(packed, g, state,
                                                          grad_scale=0.5,
                                                          bucket_bytes=1024)
                assert not bool(flag)
        outs.append((packed, state))
    (p1, s1), (p2, s2) = outs
    assert all(torch.equal(a, b) for a, b in zip(p1.arenas, p2.arenas))
    assert all(torch.equal(a, b) for a, b in zip(s1["master"], s2["master"]))
    for b1, b2 in zip(s1["inner"], s2["inner"]):
        for k in b1:
            assert torch.equal(b1[k], b2[k]), k


def test_master_weights_overflow_holds_every_arena():
    tree, grads = _o5_packed(12)
    grads["ln"][7] = float("nan")  # the fp32 arena only
    packed = PackedParams.pack(tree)
    mw = MasterWeights(FusedAdam(lr=1e-2))
    state = mw.init(packed)
    before = ([a.clone() for a in packed.arenas], [m.clone() for m in state["master"]])
    packed, state, flag = mw.step_in_backward(packed, grads, state, bucket_bytes=256)
    assert bool(flag)
    assert all(torch.equal(a, b) for a, b in zip(packed.arenas, before[0]))
    assert all(torch.equal(a, b) for a, b in zip(state["master"], before[1]))
    assert all(int(b["step"]) == 0 for b in state["inner"])


# -------------------------------------------------------------- the guard


def test_step_guard_folds_extra_found_inf():
    """StepGuard.apply_update(extra_found_inf=True) skips the step and
    shrinks the scale though the grads are finite, as JAX's guard does."""
    from beforeholiday_tpu.amp.scaler import LossScaler as JScaler
    from beforeholiday_tpu.guard import StepGuard as JGuard
    from beforeholiday_tpu_torch.amp.scaler import LossScaler
    from beforeholiday_tpu_torch.guard import StepGuard

    w = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    xv = np.asarray([1.0, -1.0, 2.0, 0.5], np.float32)
    res = {}
    for extra in (True, False):
        guard = StepGuard(LossScaler(init_scale=4.0, min_loss_scale=1.0))
        params = {"w": _t(w.copy())}
        opt = FusedSGD(lr=0.1)
        gstate, ostate = guard.init(params, device="cpu"), opt.init(params)
        vg = guard.value_and_grad(lambda p, x: torch.sum(p["w"] * x))
        _, grads, verdict = vg(params, gstate, _t(xv))
        p2, _, g2 = guard.apply_update(opt, params, grads, ostate, gstate, verdict,
                                       extra_found_inf=torch.tensor(extra))
        jguard = JGuard(JScaler(init_scale=4.0, min_loss_scale=1.0))
        jparams = {"w": jnp.asarray(w)}
        jg = jguard.init(jparams)
        jopt = JSGD(lr=0.1)
        _, jgrads, jverdict = jguard.value_and_grad(
            lambda p, x: jnp.sum(p["w"] * x))(jparams, jg, jnp.asarray(xv))
        jp2, _, jg2 = jguard.apply_update(jopt, jparams, jgrads, jopt.init(jparams), jg,
                                          jverdict, extra_found_inf=jnp.bool_(extra))
        np.testing.assert_allclose(p2["w"].numpy(), np.asarray(jp2["w"]), rtol=1e-6)
        assert float(g2["scaler"]["scale"]) == float(jg2["scaler"]["scale"])
        assert int(g2["health"]["skipped_total"]) == int(jg2["health"]["skipped_total"])
        res[extra] = (torch.equal(p2["w"], _t(w)), float(g2["scaler"]["scale"]))
    assert res[True] == (True, 2.0) and res[False][0] is False


# --------------------------------------------------------------- refusals


def test_later_pieces_raise_with_a_roadmap_pointer():
    for make in (lambda: FusedAdam(state_dtype=torch.bfloat16),
                 lambda: FusedSGD(0.1, state_dtype=torch.bfloat16),
                 lambda: FusedLAMB(state_dtype=torch.bfloat16),
                 lambda: MasterWeights(FusedAdam(), arena=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make()
    FusedAdam(state_dtype=torch.float32)  # fp32 is the port's state
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FusedLAMB().step_in_backward(torch.zeros(32768), [torch.ones(3)],
                                     FusedLAMB().init_flat(torch.zeros(32768)))
