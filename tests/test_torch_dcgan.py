"""Port parity: the multi-loss DCGAN example at amp O2
(``examples/dcgan/main_amp.py`` against
``beforeholiday_tpu_torch.examples.dcgan.main_amp``): the NHWC convolution
and transposed convolution, three training iterations of JAX's
``make_train_step`` and the port's from the same weights and batches (D on
two per-loss scalers, G on one, ``MasterWeights(FusedAdam)`` on the fp16
trees), the D step skipped when one of its losses overflows, and the per-loss
``state_dict``. Small batches (8) at the example's widths. Tolerances, and
why, are in PERF.md.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu_torch.examples.dcgan import main_amp as tdcgan
from beforeholiday_tpu_torch.ops.arena import tree_flatten


def _load_jax_example():
    """The repo's ``examples/dcgan/main_amp.py`` under a name of its own: the
    ImageNet example's module is also ``main_amp``, and a test worker may
    have imported it first."""
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "dcgan",
                        "main_amp.py")
    spec = importlib.util.spec_from_file_location("jax_dcgan_main_amp", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jdcgan = _load_jax_example()

BATCH, STEPS, LR = 8, 3, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _native_cpu_convs():
    """PyTorch's native CPU convolutions take fp16 (the oneDNN ones are off,
    as in the ResNet tests)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _weights():
    kd, kg = jax.random.split(jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, jdcgan.init_discriminator(kd)),
            jax.tree.map(np.asarray, jdcgan.init_generator(kg)))


def _port(dn, gn):
    return tdcgan.build("O2", d_params=tdcgan.params_from_numpy(dn, device="cpu"),
                        g_params=tdcgan.params_from_numpy(gn, device="cpu"),
                        device="cpu")


def _states(d, g, device=None):
    init = (lambda s: s.init()) if device is None else (lambda s: s.init(device=device))
    return (d.params, g.params, d.optimizer.init(d.params),
            g.optimizer.init(g.params), tuple(init(s) for s in (*d.scalers, *g.scalers)))


@pytest.mark.parametrize("kind", ["conv", "deconv"])
def test_convolutions_match_jax(kind):
    """XLA's "SAME" 4 x 4 stride-2 convolution and transposed convolution
    over NHWC and HWIO, in fp32: the same sums, so close to fp32 rounding."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 5).astype(np.float32)
    w = rng.randn(4, 4, 5, 6).astype(np.float32)
    fj, ft = ((jdcgan._conv, tdcgan._conv) if kind == "conv"
              else (jdcgan._deconv, tdcgan._deconv))
    want = np.asarray(fj(jnp.asarray(x), jnp.asarray(w), 2))
    got = ft(torch.from_numpy(x), torch.from_numpy(w), 2).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def runs():
    dn, gn = _weights()
    jd, jg = jdcgan.build("O2")
    td, tg = _port(dn, gn)
    jstep, tstep = jdcgan.make_train_step(jd, jg), tdcgan.make_train_step(td, tg)
    js, ts = _states(jd, jg), _states(td, tg, "cpu")
    out = []
    with torch.backends.mkldnn.flags(enabled=False):
        for real, z in tdcgan.synthetic_batches(BATCH, STEPS):
            *js, jm = jstep(*js, jnp.asarray(real), jnp.asarray(z))
            *ts, tm = tstep(*ts, torch.from_numpy(real), torch.from_numpy(z))
            out.append((jax.tree.map(np.asarray, (js, jm)), (ts, tm)))
    return td, out


@pytest.mark.parametrize("step", range(STEPS))
def test_iteration_matches_jax(runs, step):
    """errD, errG and D(x); D's and G's fp16 params and fp32 masters, Adam's
    step counts and every scaler state after each of three iterations."""
    _, out = runs
    (js, jm), (ts, tm) = out[step]
    for k in ("errD", "errG", "D_x"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for b in (0, 1):  # D, G
        for key in js[b]:
            assert ts[b][key].dtype == torch.float16
            # Adam's first step moves each weight by about lr: a gradient
            # near 0 that flips sign parts the two by 2 lr, and more steps
            # add to it
            np.testing.assert_allclose(_f32(ts[b][key]), _f32(js[b][key]),
                                       rtol=0, atol=2 * LR * (step + 1))
            np.testing.assert_allclose(
                _f32(ts[2 + b]["master"][key]), _f32(js[2 + b]["master"][key]),
                rtol=0, atol=2 * LR * (step + 1))
        assert int(ts[2 + b]["inner"]["step"]) == int(js[2 + b]["inner"]["step"]) \
            == step + 1
    for s_t, s_j in zip(ts[4], js[4]):
        for key in ("scale", "unskipped", "consecutive_overflows"):
            assert s_t[key].item() == s_j[key].item()


def test_losses_finite_and_d_learns(runs):
    _, out = runs
    d_x = [float(tm["D_x"]) for _, (_, tm) in out]
    assert all(np.isfinite([float(tm[k]) for _, (_, tm) in out
                            for k in ("errD", "errG")]))
    assert d_x[-1] > d_x[0]


def test_per_loss_state_dict_round_trips(runs):
    td, out = runs
    (ts, _) = out[-1][1]
    scalers = list(ts[4][:2])
    sd = td.state_dict(scalers)
    assert set(sd) == {"loss_scaler0", "loss_scaler1"}
    back = td.load_state_dict(sd, device="cpu")
    assert len(back) == 2
    for a, b in zip(back, scalers):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_d_step_skips_when_one_loss_overflows():
    """The fake loss's scaler at 2^24: its fp16 gradients overflow, so D's
    step is skipped (params, masters and moments bitwise unchanged) and only
    that scaler halves, in both packages; G still steps."""
    dn, gn = _weights()
    jd, jg = jdcgan.build("O2")
    td, tg = _port(dn, gn)
    real, z = next(tdcgan.synthetic_batches(BATCH, 1))
    js, ts = list(_states(jd, jg)), list(_states(td, tg, "cpu"))
    js[4] = (js[4][0], {**js[4][1], "scale": jnp.float32(2.0 ** 24)}, js[4][2])
    ts[4] = (ts[4][0], {**ts[4][1], "scale": torch.tensor(2.0 ** 24)}, ts[4][2])
    t_before = [{k: v.clone() for k, v in ts[0].items()},
                {k: v.clone() for k, v in ts[2]["master"].items()}]
    j_before = jax.tree.map(np.array, (js[0], js[2]["master"]))
    *js, _ = jdcgan.make_train_step(jd, jg)(*js, jnp.asarray(real), jnp.asarray(z))
    *ts, _ = tdcgan.make_train_step(td, tg)(*ts, torch.from_numpy(real),
                                            torch.from_numpy(z))
    for key in t_before[0]:
        assert torch.equal(ts[0][key], t_before[0][key])
        assert torch.equal(ts[2]["master"][key], t_before[1][key])
        np.testing.assert_array_equal(np.asarray(js[0][key]), j_before[0][key])
    assert int(ts[2]["inner"]["step"]) == int(js[2]["inner"]["step"]) == 0
    assert int(ts[3]["inner"]["step"]) == int(js[3]["inner"]["step"]) == 1
    assert ts[4][1]["scale"].item() == float(js[4][1]["scale"]) == 2.0 ** 23
    assert ts[4][0]["scale"].item() == float(js[4][0]["scale"]) == 2.0 ** 16


def test_impl_reaches_the_optimizers_and_scalers():
    """``build(impl="torch")`` puts both FusedAdams on their plain version
    and ``make_train_step(impl="torch")`` the unscales (the card's parity
    run of ``chip_smoke.py`` compares the two paths); on the CPU both paths
    are the plain one, so an iteration is bitwise the default's."""
    dn, gn = _weights()
    out = []
    with torch.backends.mkldnn.flags(enabled=False):
        for impl in (None, "torch"):
            d, g = tdcgan.build("O2", device="cpu", impl=impl,
                                d_params=tdcgan.params_from_numpy(dn, device="cpu"),
                                g_params=tdcgan.params_from_numpy(gn, device="cpu"))
            assert d.optimizer.inner.impl == g.optimizer.inner.impl == impl
            real, z = next(tdcgan.synthetic_batches(BATCH, 1))
            out.append(tdcgan.make_train_step(d, g, impl=impl)(
                *_states(d, g, "cpu"), torch.from_numpy(real), torch.from_numpy(z)))
    for a, b in zip(*(tree_flatten(o)[0] for o in out)):
        assert torch.equal(a, b)


def test_main_runs_on_the_cpu(capsys):
    """The example's entry point, as JAX's TestDCGAN drives it: 5 iterations
    of the multi-loss loop, finite losses, the per-loss scalers through the
    state dict."""
    err_d, err_g = tdcgan.main(["--iters", "5", "--batch", "8", "--opt-level", "O2",
                                "--device", "cpu"])
    assert np.isfinite(err_d) and np.isfinite(err_g)
    assert "done" in capsys.readouterr().out
