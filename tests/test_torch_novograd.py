"""Port parity: ``multi_tensor_novograd`` (kernel K18's plain path) and
``FusedNovoGrad``, held against the JAX package on the same numpy inputs.
The ImageNet trainer with it is held against the JAX trainer in
``test_torch_imagenet.py``.

The JAX side runs its Pallas NovoGrad kernel in interpret mode
(``impl="pallas"``) and its jnp path (``impl="jnp"``). The per-tensor
second moments are plain arithmetic on both sides (sums of squares in
another order), so rtol 1e-6 with an atol of 1e-7 (PERF.md's table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import multi_tensor as jmt
from beforeholiday_tpu.optimizers import FusedNovoGrad as JFusedNovoGrad
from beforeholiday_tpu_torch.ops import arena as tarena
from beforeholiday_tpu_torch.ops import multi_tensor as tmt
from beforeholiday_tpu_torch.optimizers import FusedNovoGrad, supports_flat_step

SHAPES = [(3, 5), (7,), (2, 3, 4), (1000,), (1,)]
TOL = dict(rtol=1e-6, atol=1e-7)


def _list(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]


def _torch(lst):
    return [torch.from_numpy(a.copy()) for a in lst]


VARIANTS = {  # name -> moment_mode, bias_correction, grad_averaging
    "mode0": (0, True, True),
    "mode1": (1, True, True),
    "mode0_plain": (0, False, False),
}


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_multi_tensor_novograd_matches_jax(jax_impl, variant):
    """Four steps: v = ‖g‖² on step 1, the running blend after, a skipped
    third step (an inf in g, ``found_inf`` set, the step count held) that
    leaves p, m and v bitwise unchanged; p, m and v after each step."""
    mode, bc, ga = VARIANTS[variant]
    hyper = dict(lr=0.05, beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=0.01,
                 bias_correction=bc, grad_averaging=ga, moment_mode=mode)
    p0 = _list(0)
    jp, jm = [jnp.asarray(a) for a in p0], [jnp.zeros(s) for s in SHAPES]
    jv = jnp.zeros(len(SHAPES), jnp.float32)
    tp, tm = _torch(p0), [torch.zeros(s) for s in SHAPES]
    tv = torch.zeros(len(SHAPES))
    step = 1
    for i in range(4):
        g = _list(10 + i, scale=0.1)
        skip = i == 2
        if skip:
            g[1][3] = np.inf
        before = [t.clone() for t in tp + tm] + [tv.clone()]
        jp, jm, jv = jmt.multi_tensor_novograd(
            [jnp.asarray(a) for a in g], jp, jm, jv, step=step,
            found_inf=jnp.asarray(skip), impl=jax_impl, **hyper)
        tp, tm, tv = tmt.multi_tensor_novograd(
            _torch(g), tp, tm, tv, step=torch.tensor(step, dtype=torch.int32),
            found_inf=torch.tensor(skip), **hyper)
        if skip:
            for a, b in zip(tp + tm + [tv], before):
                assert torch.equal(a, b)
        else:
            step += 1
        for got, ref in zip(tp + tm + [tv], jp + jm + [jv]):
            assert tuple(got.shape) == ref.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", [0, 1])
def test_novograd_keeps_the_padding_zero(mode):
    """The plain version of K18 on padded arenas: the padding's denominator
    is 1 (``_segment_coef`` puts 0 there, and g / 0 would make it NaN), so
    the padding of p and m stays 0; the tensors match the list API's."""
    spec = tarena.make_spec(SHAPES)
    g, _ = tarena.flatten(_torch(_list(1, scale=0.1)))
    p, _ = tarena.flatten(_torch(_list(2)))
    m = torch.zeros(spec.padded_total)
    denom = torch.rand(spec.num_tensors, generator=torch.Generator().manual_seed(0)) + 0.5
    ref_p, ref_m = p.clone(), m.clone()
    tmt.novograd_torch(g, p, m, denom, spec, beta1=0.95, beta3=0.05, bc1=0.05,
                       lr=0.1, weight_decay=0.01, mode=mode, found_inf=None)
    assert spec.padded_total > spec.total
    assert not p[spec.total:].any() and not m[spec.total:].any()
    assert torch.isfinite(p).all() and torch.isfinite(m).all()
    # per tensor: the same arithmetic with the tensor's own denominator
    for i, (off, shape) in enumerate(zip(spec.offsets, spec.shapes)):
        n = int(np.prod(shape))
        gi, pi = g[off:off + n], ref_p[off:off + n]
        if mode == 0:
            mi = 0.05 * (gi / denom[i] + 0.01 * pi)
            pi = pi - 0.1 * (mi / 0.05)
        else:
            mi = 0.05 * gi
            pi = pi - 0.1 * ((mi / 0.05) / denom[i] + 0.01 * pi)
        torch.testing.assert_close(m[off:off + n], mi, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(p[off:off + n], pi, rtol=1e-6, atol=1e-7)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


STEPS = [  # (lr from the host schedule, found_inf)
    (0.05, False), (0.04, True), (0.03, False), (0.02, False)]


@pytest.mark.parametrize("moment_mode", [0, 1])
def test_fused_novograd_matches_jax(moment_mode):
    """Four steps with a per-step lr, a skipped second step, a grad scale
    and one leaf kept out of the decay: params, first moments, the
    per-tensor second moments (one fp32 scalar a leaf) and the step count
    after each."""
    mask = {"a": False, "b": {"c": True, "d": False}}
    kw = dict(lr=0.1, weight_decay=0.01, moment_mode=moment_mode,
              no_weight_decay_mask=mask)
    jopt, topt = JFusedNovoGrad(impl="jnp", **kw), FusedNovoGrad(**kw)
    assert not supports_flat_step(topt)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = tarena.tree_map(torch.from_numpy, _tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    assert all(v.shape == () and v.dtype == torch.float32
               for v in tarena.tree_flatten(ts["v_per_tensor"])[0])
    for i, (lr, skip) in enumerate(STEPS):
        grads = _tree(10 + i)
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, grads), js,
                           found_inf=jnp.asarray(skip), grad_scale=0.5, lr=lr)
        tp, ts = topt.step(tp, tarena.tree_map(torch.from_numpy, grads), ts,
                           found_inf=torch.tensor(skip),
                           grad_scale=torch.tensor(0.5), lr=lr)
        assert int(ts["step"]) == int(js["step"]) == [1, 1, 2, 3][i]
        for key in ("exp_avg", "v_per_tensor"):
            assert tarena.tree_paths(ts[key]) == tarena.tree_paths(tp)
        for got, ref in ((tp, jp), (ts["exp_avg"], js["exp_avg"]),
                         (ts["v_per_tensor"], js["v_per_tensor"])):
            for a, b in zip(tarena.tree_flatten(got)[0], jax.tree.leaves(ref)):
                assert tuple(a.shape) == b.shape
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_novograd_kernel_refuses_cpu_tensors():
    """On the CPU the list API takes the plain version; K18 takes CUDA
    arenas only, and an explicit impl='kernel' raises."""
    spec = tarena.make_spec([(8,)])
    x = torch.zeros(spec.padded_total)
    with pytest.raises(ValueError):
        tmt.novograd_kernel(x, x, x, torch.ones(1), spec, beta1=0.95,
                            beta3=0.05, bc1=1.0, lr=0.1, weight_decay=0.0,
                            mode=0, found_inf=None)
    with pytest.raises(ValueError):
        tmt.multi_tensor_novograd([torch.zeros(8)], [torch.zeros(8)],
                                  [torch.zeros(8)], torch.zeros(1), lr=0.1,
                                  impl="kernel")
