"""Port parity: ``multi_tensor_adagrad`` (kernel K17's plain path) and
``FusedAdagrad``, held against the JAX package on the same numpy inputs,
and ``FusedAdagrad`` against ``torch.optim.Adagrad``. The ImageNet trainer
with it is held against the JAX trainer in ``test_torch_imagenet.py``.

The JAX side runs its Pallas Adagrad kernel in interpret mode
(``impl="pallas"``) and its jnp path (``impl="jnp"``). Tolerances, and why,
are in PERF.md's table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import multi_tensor as jmt
from beforeholiday_tpu.optimizers import FusedAdagrad as JFusedAdagrad
from beforeholiday_tpu_torch.ops import arena as tarena
from beforeholiday_tpu_torch.ops import multi_tensor as tmt
from beforeholiday_tpu_torch.optimizers import FusedAdagrad, supports_flat_step

SHAPES = [(3, 5), (7,), (2, 3, 4), (1000,)]
# the same fp32 sequence on both sides (JAX's Pallas kernel takes lr and eps
# from fp32 SMEM, as the port takes them from fp32 device scalars)
TOL = dict(rtol=1e-6, atol=1e-7)


def _lists(seed):
    rng = np.random.default_rng(seed)
    g = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    p = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    h = [(0.1 * rng.random(s)).astype(np.float32) for s in SHAPES]
    return g, p, h


def _torch(lst):
    return [torch.from_numpy(a.copy()) for a in lst]


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("mode", [0, 1])
def test_multi_tensor_adagrad_matches_jax(jax_impl, mode):
    """Three steps, the decay as L2 (mode 0) or decoupled (mode 1), lr a
    device scalar on the port's side: params and sums after each."""
    _, p, h = _lists(0)
    jp, jh = [jnp.asarray(a) for a in p], [jnp.asarray(a) for a in h]
    tp, th = _torch(p), _torch(h)
    for step in range(3):
        g = _lists(10 + step)[0]
        jp, jh = jmt.multi_tensor_adagrad(
            [jnp.asarray(a) for a in g], jp, jh, lr=0.05, eps=1e-10,
            weight_decay=0.01, mode=mode, impl=jax_impl)
        tin = tp
        tp, th = tmt.multi_tensor_adagrad(
            _torch(g), tp, th, lr=torch.tensor(0.05), eps=1e-10,
            weight_decay=0.01, mode=mode)
        assert not any(a is b for a, b in zip(tp, tin))  # new tensors
        for got, ref in zip(tp + th, jp + jh):
            assert tuple(got.shape) == ref.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
def test_multi_tensor_adagrad_skip_is_identity(jax_impl):
    """An inf in the gradient and ``found_inf`` set: params and sums come
    back bitwise unchanged on both sides."""
    g, p, h = _lists(1)
    g[2].reshape(-1)[5] = np.inf
    jp, jh = jmt.multi_tensor_adagrad(
        [jnp.asarray(a) for a in g], [jnp.asarray(a) for a in p],
        [jnp.asarray(a) for a in h], lr=0.05, weight_decay=0.01,
        found_inf=jnp.asarray(True), impl=jax_impl)
    tp, th = tmt.multi_tensor_adagrad(_torch(g), _torch(p), _torch(h), lr=0.05,
                                      weight_decay=0.01,
                                      found_inf=torch.tensor(True))
    for got, jref, ref in zip(tp + th, jp + jh, p + h):
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(np.asarray(jref), ref)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


STEPS = [  # (lr from the host schedule, found_inf)
    (0.05, False), (0.04, True), (0.03, False), (0.02, False)]


@pytest.mark.parametrize("adagrad_w_mode", [False, True])
def test_fused_adagrad_matches_jax(adagrad_w_mode):
    """Four steps with a per-step lr, a skipped second step, a grad scale
    and one leaf kept out of the decay: params, sums and the step count
    after each."""
    mask = {"a": False, "b": {"c": True, "d": False}}
    kw = dict(lr=0.1, eps=1e-10, weight_decay=0.01,
              adagrad_w_mode=adagrad_w_mode, no_weight_decay_mask=mask)
    jopt, topt = JFusedAdagrad(impl="jnp", **kw), FusedAdagrad(**kw)
    assert not supports_flat_step(topt)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = tarena.tree_map(torch.from_numpy, _tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for i, (lr, skip) in enumerate(STEPS):
        grads = _tree(10 + i)
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, grads), js,
                           found_inf=jnp.asarray(skip), grad_scale=0.5, lr=lr)
        tp, ts = topt.step(tp, tarena.tree_map(torch.from_numpy, grads), ts,
                           found_inf=torch.tensor(skip),
                           grad_scale=torch.tensor(0.5), lr=lr)
        assert int(ts["step"]) == int(js["step"]) == [1, 1, 2, 3][i]
        for got, ref in ((tp, jp), (ts["sum"], js["sum"])):
            for a, b in zip(tarena.tree_flatten(got)[0], jax.tree.leaves(ref)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_fused_adagrad_matches_torch_adagrad():
    """Ten steps against ``torch.optim.Adagrad`` (L2 decay, no lr decay,
    zero initial sums): the tolerance of the JAX package's own test of its
    FusedAdagrad against it."""
    leaves = [torch.from_numpy(x.copy()) for x in jax.tree.leaves(_tree(0))]
    ref = [torch.nn.Parameter(x.clone()) for x in leaves]
    adagrad = torch.optim.Adagrad(ref, lr=1e-2, eps=1e-10, weight_decay=0.01)
    opt = FusedAdagrad(lr=1e-2, eps=1e-10, weight_decay=0.01)
    state = opt.init(leaves)
    rng = np.random.RandomState(5)
    for _ in range(10):
        grads = [torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
                 for x in leaves]
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        adagrad.step()
        leaves, state = opt.step(leaves, grads, state)
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_adagrad_kernel_refuses_cpu_tensors():
    """On the CPU the list API takes the plain version; K17 takes CUDA
    arenas only, and an explicit impl='kernel' raises."""
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        tmt.adagrad_kernel(x, x, x, lr=0.1, eps=1e-10, weight_decay=0.0, mode=0,
                           found_inf=None)
    with pytest.raises(ValueError):
        tmt.multi_tensor_adagrad([x], [x], [x], lr=0.1, impl="kernel")
