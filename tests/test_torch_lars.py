"""Port parity: ``multi_tensor_lars`` (per-tensor trust ratios, then kernel
K10's plain path), ``FusedLARS`` and ``LARC``, held against the JAX package
on the same numpy inputs. The ImageNet trainer with FusedLARS and with
``use_larc`` is held against the JAX trainer in ``test_torch_imagenet.py``.

The JAX side runs its Pallas SGD kernel in interpret mode
(``impl="pallas"``) and its jnp path (``impl="jnp"``). The norms are sums
of squares in another order, so rtol 1e-6 with an atol of 1e-7 (PERF.md's
table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import multi_tensor as jmt
from beforeholiday_tpu.optimizers import FusedLARS as JFusedLARS
from beforeholiday_tpu.optimizers import FusedSGD as JFusedSGD
from beforeholiday_tpu.parallel import LARC as JLARC
from beforeholiday_tpu_torch.ops import arena as tarena
from beforeholiday_tpu_torch.ops import multi_tensor as tmt
from beforeholiday_tpu_torch.optimizers import FusedLARS, FusedSGD, supports_flat_step
from beforeholiday_tpu_torch.parallel import LARC

SHAPES = [(3, 5), (7,), (2, 3, 4), (1000,)]
TOL = dict(rtol=1e-6, atol=1e-7)


def _lists(seed):
    """g, p, m; the second tensor's gradient is 0 and the third's param is 0,
    so their trust ratio is 1."""
    rng = np.random.default_rng(seed)
    g, p, m = ([rng.standard_normal(s).astype(np.float32) for s in SHAPES]
               for _ in range(3))
    g[1][:] = 0
    p[2][:] = 0
    return g, p, m


def _torch(lst):
    return [torch.from_numpy(a.copy()) for a in lst]


VARIANTS = {  # the ImageNet recipe and the other SGD options
    "resnet": dict(momentum=0.9, weight_decay=1e-4),
    "nesterov": dict(momentum=0.9, nesterov=True, weight_decay=0.01,
                     wd_after_momentum=True),
    "dampening": dict(momentum=0.9, dampening=0.1, weight_decay=0.01,
                      epsilon=1e-3, trust_coefficient=0.02),
    "no_momentum": dict(momentum=0.0, weight_decay=0.0),
}


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("first_run", [True, False])
def test_multi_tensor_lars_matches_jax(jax_impl, variant, first_run):
    """One step with a gradient scale: params and momentum buffers (a zero
    gradient and a zero param keep the trust ratio at 1;
    ``wd_after_momentum`` is dropped on both sides)."""
    g, p, m = _lists(0)
    hyper = dict(lr=0.1, scale=0.5, **VARIANTS[variant])
    jp, jm = jmt.multi_tensor_lars(
        [jnp.asarray(a) for a in g], [jnp.asarray(a) for a in p],
        [jnp.asarray(a) for a in m], first_run=jnp.asarray(first_run),
        impl=jax_impl, **hyper)
    tp, tm = tmt.multi_tensor_lars(_torch(g), _torch(p), _torch(m),
                                   first_run=torch.tensor(first_run), **hyper)
    for got, ref in zip(tp + tm, jp + jm):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
def test_multi_tensor_lars_skip_is_identity(jax_impl):
    g, p, m = _lists(1)
    g[3][7] = np.inf
    jp, jm = jmt.multi_tensor_lars(
        [jnp.asarray(a) for a in g], [jnp.asarray(a) for a in p],
        [jnp.asarray(a) for a in m], lr=0.1, momentum=0.9, weight_decay=1e-4,
        found_inf=jnp.asarray(True), impl=jax_impl)
    tp, tm = tmt.multi_tensor_lars(_torch(g), _torch(p), _torch(m), lr=0.1,
                                   momentum=0.9, weight_decay=1e-4,
                                   found_inf=torch.tensor(True))
    for got, jref, ref in zip(tp + tm, jp + jm, p + m):
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(np.asarray(jref), ref)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


STEPS = [  # (lr from the host schedule, found_inf)
    (0.05, False), (0.04, True), (0.03, False), (0.02, False)]


def _run(jopt, topt, grad_scale=0.5, trees=_tree):
    """Four steps of both optimizers with a per-step lr and a skipped second
    step; params, states and step counts compared after each."""
    assert not supports_flat_step(topt)
    jp = jax.tree.map(jnp.asarray, trees(0))
    tp = tarena.tree_map(torch.from_numpy, trees(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for i, (lr, skip) in enumerate(STEPS):
        grads = trees(10 + i)
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, grads), js,
                           found_inf=jnp.asarray(skip), grad_scale=grad_scale,
                           lr=lr)
        tp, ts = topt.step(tp, tarena.tree_map(torch.from_numpy, grads), ts,
                           found_inf=torch.tensor(skip),
                           grad_scale=torch.tensor(grad_scale), lr=lr)
        assert int(ts["step"]) == int(js["step"]) == [1, 1, 2, 3][i]
        for got, ref in ((tp, jp), (ts["momentum_buffer"], js["momentum_buffer"])):
            for a, b in zip(tarena.tree_flatten(got)[0], jax.tree.leaves(ref)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_fused_lars_matches_jax():
    """FusedLARS with the ImageNet recipe's momentum and decay, one leaf
    kept out of the decay, a grad scale: the first unskipped step seeds the
    momentum buffers."""
    mask = {"a": False, "b": {"c": True, "d": False}}
    kw = dict(momentum=0.9, weight_decay=1e-4, no_weight_decay_mask=mask)
    _run(JFusedLARS(0.1, impl="jnp", **kw), FusedLARS(0.1, **kw))


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_larc_matches_jax(clip, weight_decay):
    """LARC around FusedSGD with momentum: the loss scale unscaled before
    the conditioning, the clip to the group lr and LARC's own decay; a leaf
    whose gradient is 0 keeps its gradient (and does not decay)."""
    def trees(seed):
        tree = _tree(seed)
        if seed >= 10:  # a gradient: leaf "c"'s is 0
            tree["b"]["c"][:] = 0
        return tree

    kw = dict(trust_coefficient=0.02, clip=clip, weight_decay=weight_decay)
    jlarc = JLARC(JFusedSGD(0.5, momentum=0.9, impl="jnp"), **kw)
    tlarc = LARC(FusedSGD(0.5, momentum=0.9), **kw)
    _run(jlarc, tlarc, trees=trees)


def test_larc_clips_and_keeps_zero_gradients():
    """The JAX package's own LARC cases on the port: a huge param norm is
    clipped to the group lr (the step is lr·g exactly), and a zero gradient
    leaves the param where it is."""
    p = {"w": torch.full((16,), 100.0)}
    larc = LARC(FusedSGD(0.1), trust_coefficient=0.02, clip=True)
    p1, _ = larc.step(p, {"w": torch.full((16,), 1e-3)}, larc.init(p))
    torch.testing.assert_close(p1["w"], torch.full((16,), 100.0 - 0.1 * 1e-3))
    q = {"w": torch.full((4,), 3.0)}
    larc = LARC(FusedSGD(0.1), clip=False, weight_decay=1e-3)
    q1, _ = larc.step(q, {"w": torch.zeros(4)}, larc.init(q))
    assert torch.equal(q1["w"], q["w"])


def test_larc_refuses_an_inner_weight_decay():
    with pytest.raises(ValueError, match="weight decay"):
        LARC(FusedSGD(0.1, weight_decay=0.1))


def test_lars_takes_k10_or_raises_on_cpu_tensors():
    """LARS runs K10 after its trust ratios: an explicit impl='kernel' on
    CPU tensors raises rather than falling back."""
    g, p, m = _lists(2)
    with pytest.raises(ValueError):
        tmt.multi_tensor_lars(_torch(g), _torch(p), _torch(m), lr=0.1,
                              impl="kernel")
