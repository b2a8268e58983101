"""Port parity: ``sgd_flat`` and ``multi_tensor_sgd`` (kernel K10's plain
path) and ``FusedSGD`` (list and flat steps), held against the JAX package
on the same numpy inputs, and ``FusedSGD`` against ``torch.optim.SGD``.

The JAX side runs its Pallas SGD kernel in interpret mode (``impl="pallas"``)
and its jnp path (``impl="jnp"``). Tolerances: the arithmetic is the same
fp32 sequence on both sides, so rtol 1e-6 (PERF.md's tolerance table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import arena as jarena
from beforeholiday_tpu.ops import multi_tensor as jmt
from beforeholiday_tpu.optimizers import FusedSGD as JFusedSGD
from beforeholiday_tpu_torch.ops import arena as tarena
from beforeholiday_tpu_torch.ops import multi_tensor as tmt
from beforeholiday_tpu_torch.ops.arena import PackedParams
from beforeholiday_tpu_torch.optimizers import FusedSGD, MasterWeights, supports_flat_step

SHAPES = [(3, 5), (7,), (2, 3, 4), (1000,)]
TOL = dict(rtol=1e-6, atol=1e-7)

VARIANTS = {
    # the ImageNet recipe: momentum 0.9, decay 1e-4 before momentum
    "resnet": dict(momentum=0.9, dampening=0.0, nesterov=False,
                   wd_after_momentum=False, weight_decay=1e-4),
    "dampening": dict(momentum=0.9, dampening=0.1, nesterov=False,
                      wd_after_momentum=False, weight_decay=0.01),
    "nesterov": dict(momentum=0.9, dampening=0.0, nesterov=True,
                     wd_after_momentum=False, weight_decay=0.005),
    "wd_after_momentum": dict(momentum=0.9, dampening=0.0, nesterov=False,
                              wd_after_momentum=True, weight_decay=0.01),
    "no_momentum": dict(momentum=0.0, dampening=0.0, nesterov=False,
                        wd_after_momentum=False, weight_decay=0.01),
}


def _arenas(seed=0):
    """g, p, m as padded numpy arenas (zero padding, as the optimizers keep)."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in (1.0, 1.0, 0.1):
        xs = [(scale * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
        out.append(np.array(jarena.flatten([jnp.asarray(x) for x in xs])[0]))
    return out


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("first_run", [False, True])
def test_sgd_flat_matches_jax(jax_impl, variant, first_run):
    g, p, m = _arenas()
    hyper = dict(lr=0.05, scale=0.5, **VARIANTS[variant])
    jouts = jmt.sgd_flat(jnp.asarray(g), jnp.asarray(p), jnp.asarray(m),
                         first_run=jnp.asarray(first_run),
                         model_copy_dtype=jnp.bfloat16, impl=jax_impl, **hyper)
    tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    touts = tmt.sgd_flat(torch.from_numpy(g), tp, tm,
                         first_run=torch.tensor(first_run),
                         model_copy_dtype=torch.bfloat16, **hyper)
    assert touts[0] is tp and touts[1] is tm  # in place
    np.testing.assert_allclose(tp.numpy(), np.asarray(jouts[0]), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jouts[1]), **TOL)
    # the copy is the new params' cast, bit for bit on both sides
    assert torch.equal(touts[2], tp.to(torch.bfloat16))
    np.testing.assert_array_equal(_np(touts[2]), np.asarray(jouts[2], np.float32))
    n = sum(int(np.prod(s)) for s in SHAPES)
    assert not tp[n:].any() and not tm[n:].any()  # padding stays 0


def test_sgd_flat_first_run_as_python_bool():
    """A host bool selects the same seeding as the device flag."""
    g, p, m = _arenas(1)
    outs = []
    for first in (True, torch.tensor(True)):
        tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
        tmt.sgd_flat(torch.from_numpy(g), tp, tm, lr=0.1, momentum=0.9,
                     first_run=first)
        outs.append((tp, tm))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    # seeded: the buffer is the gradient itself
    assert torch.equal(outs[0][1], torch.from_numpy(g))


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
def test_sgd_flat_skip_holds_everything(jax_impl):
    g, p, m = _arenas(2)
    g[3] = np.inf
    hyper = dict(lr=0.05, **VARIANTS["resnet"])
    jouts = jmt.sgd_flat(jnp.asarray(g), jnp.asarray(p), jnp.asarray(m),
                         found_inf=jnp.asarray(True), model_copy_dtype=jnp.float32,
                         impl=jax_impl, **hyper)
    tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    copy = torch.from_numpy(p.copy())
    tmt.sgd_flat(torch.from_numpy(g), tp, tm, found_inf=torch.tensor(True),
                 model_copy=copy, **hyper)
    for got, ref, jref in ((tp, p, jouts[0]), (tm, m, jouts[1]), (copy, p, jouts[2])):
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(np.asarray(jref), ref)


@pytest.mark.parametrize("copy_dtype", [None, "bfloat16"])
def test_multi_tensor_sgd_matches_jax(copy_dtype):
    rng = np.random.default_rng(3)
    gs, ps, ms = ([rng.standard_normal(s).astype(np.float32) for s in SHAPES]
                  for _ in range(3))
    hyper = dict(lr=0.1, first_run=False, **VARIANTS["nesterov"])
    jouts = jmt.multi_tensor_sgd(
        [jnp.asarray(x) for x in gs], [jnp.asarray(x) for x in ps],
        [jnp.asarray(x) for x in ms], impl="jnp",
        model_copy_dtype=None if copy_dtype is None else jnp.bfloat16, **hyper)
    tps = [torch.from_numpy(x) for x in ps]
    touts = tmt.multi_tensor_sgd(
        [torch.from_numpy(x) for x in gs], tps, [torch.from_numpy(x) for x in ms],
        model_copy_dtype=None if copy_dtype is None else torch.bfloat16, **hyper)
    assert len(touts) == len(jouts) == (2 if copy_dtype is None else 3)
    for tlist, jlist in zip(touts, jouts):
        for got, ref in zip(tlist, jlist):
            assert tuple(got.shape) == ref.shape
            np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **TOL)
    for t, x in zip(tps, ps):  # the inputs are not modified
        np.testing.assert_array_equal(t.numpy(), x)


# --------------------------------------------------------------- FusedSGD


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


def _leaves(tree):
    return jax.tree.leaves(tree)


STEPS = [  # (lr from the host schedule, found_inf)
    (0.05, False), (0.04, True), (0.03, False), (0.02, False)]


@pytest.mark.parametrize("path", ["list", "flat"])
def test_fused_sgd_matches_jax(path):
    """Four steps with a per-step lr and a skipped second step: params,
    momentum buffers and the step count after each, the first unskipped
    step seeding the buffers."""
    params = _tree(0)
    jopt = JFusedSGD(0.1, 0.9, weight_decay=1e-4, impl="jnp")
    topt = FusedSGD(0.1, 0.9, weight_decay=1e-4)
    if path == "list":
        jp = jax.tree.map(jnp.asarray, params)
        tp = tarena.tree_map(torch.from_numpy, params)
        js, ts = jopt.init(jp), topt.init(tp)
    else:
        jp, spec = jarena.flatten([jnp.asarray(x) for x in _leaves(params)])
        tp, _ = tarena.flatten([torch.from_numpy(x) for x in _leaves(params)])
        js, ts = jopt.init_flat(jp), topt.init_flat(tp)
    for i, (lr, skip) in enumerate(STEPS):
        grads = _tree(10 + i)
        jfi, tfi = jnp.asarray(skip), torch.tensor(skip)
        if path == "list":
            jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, grads), js,
                               found_inf=jfi, lr=lr)
            tp, ts = topt.step(tp, tarena.tree_map(torch.from_numpy, grads), ts,
                               found_inf=tfi, lr=lr)
            pairs = [(tarena.tree_flatten(tp)[0], _leaves(jp)),
                     (tarena.tree_flatten(ts["momentum_buffer"])[0],
                      _leaves(js["momentum_buffer"]))]
        else:
            jg, _ = jarena.flatten([jnp.asarray(x) for x in _leaves(grads)])
            tg, _ = tarena.flatten([torch.from_numpy(x) for x in _leaves(grads)])
            jp, js = jopt.step_flat(jp, jg, js, found_inf=jfi, lr=lr)
            tp, ts = topt.step_flat(tp, tg, ts, found_inf=tfi, lr=lr)
            pairs = [([tp], [jp]), ([ts["momentum_buffer"]], [js["momentum_buffer"]])]
        assert int(ts["step"]) == int(js["step"]) == [1, 1, 2, 3][i]
        for got, ref in pairs:
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("momentum, dampening, nesterov, wd", [
    (0.0, 0.0, False, 0.0),
    (0.9, 0.0, False, 0.01),
    (0.9, 0.1, False, 0.0),
    (0.9, 0.0, True, 0.005),
])
def test_fused_sgd_matches_torch_sgd(momentum, dampening, nesterov, wd):
    """Twelve steps against ``torch.optim.SGD`` (the tolerance of the JAX
    package's own test of its FusedSGD against it)."""
    params = _tree(0)
    leaves = [torch.from_numpy(x.copy()) for x in _leaves(params)]
    ref = [torch.nn.Parameter(x.clone()) for x in leaves]
    sgd = torch.optim.SGD(ref, lr=1e-2, momentum=momentum, dampening=dampening,
                          nesterov=nesterov, weight_decay=wd)
    opt = FusedSGD(1e-2, momentum, dampening, weight_decay=wd, nesterov=nesterov)
    state = opt.init(leaves)
    rng = np.random.RandomState(4)
    for _ in range(12):
        grads = [torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
                 for x in leaves]
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        sgd.step()
        leaves, state = opt.step(leaves, grads, state)
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_fused_sgd_flat_step_and_master_weights():
    """``supports_flat_step`` holds, ``MasterWeights`` carries the step's lr
    to ``step_flat`` and writes the bf16 model arena in the same pass, and
    the view path (a list of gradient views) raises."""
    opt = FusedSGD(0.1, 0.9, weight_decay=1e-4)
    assert supports_flat_step(opt)
    assert not supports_flat_step(FusedSGD(0.1, no_weight_decay_mask=lambda p: False))
    tree = {k: torch.from_numpy(v) for k, v in _tree(0)["b"].items()}
    packed = PackedParams.pack(tarena.tree_map(lambda t: t.to(torch.bfloat16), tree))
    mw = MasterWeights(opt)
    state = mw.init(packed)
    grads = packed.replace_arenas([torch.ones(a.shape) for a in packed.arenas])
    master0 = state["master"][0].clone()
    packed, state = mw.step(packed, grads, state, lr=0.25)
    expect = master0 - 0.25 * (1.0 + 1e-4 * master0)  # first step: m = g + wd p
    n = packed.layout.specs[0].total
    torch.testing.assert_close(state["master"][0][:n], expect[:n], rtol=1e-6, atol=1e-7)
    assert torch.equal(packed.arenas[0], state["master"][0].to(torch.bfloat16))
    assert int(state["inner"][0]["step"]) == 1
    # the view path: a list of gradient leaves must cover the arena
    with pytest.raises(ValueError, match="cover exactly"):
        opt.step_flat(state["master"][0], [torch.ones(state["master"][0].numel() + 1)],
                      state["inner"][0])


def test_nesterov_needs_momentum_and_no_dampening():
    with pytest.raises(ValueError):
        FusedSGD(0.1, 0.0, nesterov=True)
    with pytest.raises(ValueError):
        FusedSGD(0.1, 0.9, 0.1, nesterov=True)


def test_sgd_kernel_refuses_cpu_tensors():
    """On the CPU the wrapper takes the plain version; the kernel itself
    takes CUDA arenas only, and an explicit impl='kernel' raises."""
    g, p, m = (torch.zeros(8) for _ in range(3))
    with pytest.raises(ValueError):
        tmt.sgd_kernel(g, p, m, lr=0.1, weight_decay=0.0, momentum=0.9,
                       dampening=0.0, nesterov=False, first_run=False,
                       wd_after_momentum=False, scale=1.0, found_inf=None,
                       copy_out=None)
    with pytest.raises(ValueError):
        tmt.sgd_flat(g, p, m, lr=0.1, impl="kernel")
