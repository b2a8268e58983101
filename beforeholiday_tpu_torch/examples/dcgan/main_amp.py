"""DCGAN with amp — counterpart of ``examples/dcgan/main_amp.py``, the
multi-loss, multi-optimizer example: two models, two optimizers, three
backward passes an iteration through per-loss scalers.

The generator and the discriminator are NHWC functions over a params dict
with HWIO weights, as in the JAX example; their convolutions are cuDNN
through ``F.conv2d`` and ``F.conv_transpose2d`` (the JAX package leaves them
to XLA and writes no kernel for them). ``amp.initialize`` runs once a model:
D with ``num_losses=2`` (its real and fake losses, each on its own dynamic
scaler at O2) and G with one, each optimizer ``MasterWeights(FusedAdam(lr=
2e-4, betas=(0.5, 0.999)))`` at O2 on the params tree: fp32 masters, the
fp16 model written back after each step. D's step skips when either of its
two losses overflows; G's loss goes through the updated D. Nothing is read
back to the host inside a step.

The JAX step donates its state buffers (``remat.donate_step``); here the
optimizers return new tensors and the old ones are freed when the caller
rebinds them, so there is nothing to donate. :func:`params_from_numpy`
takes the JAX example's parameters, so both start from the same weights.

Run (synthetic data)::

    python -m beforeholiday_tpu_torch.examples.dcgan.main_amp --iters 20
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch import amp
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.optimizers import FusedAdam
from beforeholiday_tpu_torch.testing._model_utils import params_from_numpy  # noqa: F401

IMG = 32
NZ = 64


def _conv(x, w, stride):
    """NHWC x, HWIO w (4 x 4, stride 2): XLA's "SAME" padding is one a
    side here. Computes in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def _deconv(x, w, stride):
    """``jax.lax.conv_transpose(x, w, stride, "SAME")`` for NHWC x and HWIO
    w (4 x 4, stride 2): the input dilated by the stride and correlated,
    padded by 2 a side, with w as it is. ``F.conv_transpose2d`` correlates
    with the kernel flipped, so it gets w flipped back, as (in, out, kh,
    kw)."""
    wt = w.to(x.dtype).permute(2, 3, 0, 1).flip(2, 3)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def _normal(generator, shape, device):
    t = torch.randn(shape, generator=generator, device=generator.device)
    return (t * 0.02).to(device)


def init_generator(generator: torch.Generator, ngf: int = 32, device=None):
    """fp32 generator weights with the JAX example's shapes and std 0.02."""
    device = resolve_device(device)
    return {
        "dense": _normal(generator, (NZ, 4 * 4 * ngf * 4), device),
        "deconv1": _normal(generator, (4, 4, ngf * 4, ngf * 2), device),
        "deconv2": _normal(generator, (4, 4, ngf * 2, ngf), device),
        "deconv3": _normal(generator, (4, 4, ngf, 3), device),
    }


def generator(p, z):
    """z (N, NZ) -> images (N, 32, 32, 3) in [-1, 1]."""
    ngf4 = p["deconv1"].shape[2]
    h = torch.relu((z @ p["dense"].to(z.dtype)).reshape(-1, 4, 4, ngf4))
    h = torch.relu(_deconv(h, p["deconv1"], 2))
    h = torch.relu(_deconv(h, p["deconv2"], 2))
    return torch.tanh(_deconv(h, p["deconv3"], 2))


def init_discriminator(generator: torch.Generator, ndf: int = 32, device=None):
    """fp32 discriminator weights with the JAX example's shapes and std 0.02."""
    device = resolve_device(device)
    return {
        "conv1": _normal(generator, (4, 4, 3, ndf), device),
        "conv2": _normal(generator, (4, 4, ndf, ndf * 2), device),
        "conv3": _normal(generator, (4, 4, ndf * 2, ndf * 4), device),
        "dense": _normal(generator, (4 * 4 * ndf * 4, 1), device),
    }


def discriminator(p, x):
    """images (N, 32, 32, 3) -> logits (N,)."""
    h = F.leaky_relu(_conv(x, p["conv1"], 2), 0.2)
    h = F.leaky_relu(_conv(h, p["conv2"], 2), 0.2)
    h = F.leaky_relu(_conv(h, p["conv3"], 2), 0.2)
    return (h.reshape(h.shape[0], -1) @ p["dense"].to(h.dtype))[:, 0]


def bce_logits(logits, target):
    """BCEWithLogits in fp32 (``amp.functional``'s): amp-safe, unlike the
    banned plain BCE. ``target`` is a number or a tensor."""
    return amp.functional.binary_cross_entropy_with_logits(logits.float(), target)


def build(opt_level: str = "O2", lr: float = 2e-4, seed: int = 0, *,
          d_params=None, g_params=None, device=None, impl=None):
    """``(d, g)``: one ``AmpModel`` a model. D trains under two losses
    (real, fake) with two scalers, G under one. ``d_params``/``g_params``
    (both or neither) start from given fp32 weights, for example the JAX
    example's through :func:`params_from_numpy`; otherwise they are drawn
    from ``seed``. ``impl="torch"`` puts the optimizers on their plain
    versions (pass the same to :func:`make_train_step` for the scalers)."""
    device = resolve_device(device)
    if (d_params is None) != (g_params is None):
        raise ValueError("pass both d_params and g_params, or neither")
    if d_params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        d_params = init_discriminator(gen, device=device)
        g_params = init_generator(gen, device=device)
    d = amp.initialize(discriminator, d_params,
                       FusedAdam(lr=lr, betas=(0.5, 0.999), impl=impl), opt_level,
                       num_losses=2, cast_model_outputs=torch.float32)
    g = amp.initialize(generator, g_params,
                       FusedAdam(lr=lr, betas=(0.5, 0.999), impl=impl), opt_level,
                       num_losses=1, cast_model_outputs=torch.float32)
    return d, g


def make_train_step(d: Any, g: Any, impl=None):
    """``train_step(dp, gp, d_opt, g_opt, scalers, real, z) -> (dp, gp,
    d_opt, g_opt, scalers, metrics)``: D's two scaled losses, their
    gradients summed and one D step (skipped if either overflowed), then
    G's non-saturating loss through the updated D and one G step.
    ``scalers`` is ``(real, fake, generator)``; the metrics stay on the
    device. ``impl="torch"`` unscales on the plain version of K5."""

    def d_real_loss(p, real):
        logits = d.apply(p, real)
        return bce_logits(logits, 1.0), logits

    def d_fake_loss(p, fake):
        return bce_logits(d.apply(p, fake), 0.0)

    svag_real = amp.scaled_value_and_grad(d_real_loss, d.scalers[0],
                                          has_aux=True, impl=impl)
    svag_fake = amp.scaled_value_and_grad(d_fake_loss, d.scalers[1], impl=impl)

    def train_step(dp, gp, d_opt, g_opt, scalers, real, z):
        s_real, s_fake, s_gen = scalers
        with torch.no_grad():
            fake = g.apply(gp, z)
        errD_real, real_logits, gr, inf_r, s_real = svag_real(dp, s_real, real)
        errD_fake, gf, inf_f, s_fake = svag_fake(dp, s_fake, fake)
        # the two backwards' gradients add up before the one D step
        grads_d = _tree_add(gr, gf)
        dp, d_opt = d.optimizer.step(dp, grads_d, d_opt,
                                     found_inf=torch.logical_or(inf_r, inf_f))

        def g_loss(p, z):
            return bce_logits(d.apply(dp, g.apply(p, z)), 1.0)

        errG, gg, inf_g, s_gen = amp.scaled_value_and_grad(
            g_loss, g.scalers[0], impl=impl)(gp, s_gen, z)
        gp, g_opt = g.optimizer.step(gp, gg, g_opt, found_inf=inf_g)
        metrics = {"errD": errD_real + errD_fake, "errG": errG,
                   "D_x": torch.sigmoid(real_logits).mean()}
        return dp, gp, d_opt, g_opt, (s_real, s_fake, s_gen), metrics

    return train_step


def _tree_add(a, b):
    return {k: _tree_add(a[k], b[k]) for k in a} if isinstance(a, dict) else a + b


def synthetic_batches(batch: int, n: int, seed: int = 0):
    """``(real, z)`` numpy pairs, the JAX example's stream: images uniform in
    [-1, 1) and normal codes."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        real = rng.rand(batch, IMG, IMG, 3).astype(np.float32) * 2 - 1
        z = rng.randn(batch, NZ).astype(np.float32)
        yield real, z


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    d, g = build(args.opt_level, device=device)
    dp, gp = d.params, g.params
    d_opt, g_opt = d.optimizer.init(dp), g.optimizer.init(gp)
    scalers = tuple(s.init(device=device) for s in (*d.scalers, *g.scalers))
    step = make_train_step(d, g)
    for i, (real, z) in enumerate(synthetic_batches(args.batch, args.iters)):
        real, z = torch.from_numpy(real).to(device), torch.from_numpy(z).to(device)
        dp, gp, d_opt, g_opt, scalers, m = step(dp, gp, d_opt, g_opt, scalers, real, z)
        if (i + 1) % 5 == 0:
            print(f"[{i + 1}/{args.iters}] Loss_D {float(m['errD']):.4f} "
                  f"Loss_G {float(m['errG']):.4f} D(x) {float(m['D_x']):.3f}")
    # the per-loss scaler states round-trip through the state dict
    sd = d.state_dict(list(scalers[:2]))
    assert set(sd) == {"loss_scaler0", "loss_scaler1"}
    print("done")
    return float(m["errD"]), float(m["errG"])


if __name__ == "__main__":
    main()
