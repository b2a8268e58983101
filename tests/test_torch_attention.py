"""Port parity: flash attention forward and backward (kernels K2/K4's plain
paths), held against the JAX package on the same numpy inputs. The JAX side
runs its Pallas kernels in interpret mode where the lengths tile by 128, and
its jnp oracle otherwise (decode's Sq=1 included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import attention as jattn
from beforeholiday_tpu_torch.ops import attention as tattn

ATOL = 2e-5


def _qkv(B, H, S, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    return q, k, v


# (B, H, S, Sk, D, causal, kv_lens, scale, jax impl)
CASES = {
    "causal_tiled": (1, 2, 128, 128, 32, True, None, None, "pallas"),
    "ragged_lens_with_zero": (3, 2, 128, 128, 16, False, [128, 37, 0], None,
                              "pallas"),
    "causal_ragged_scale": (2, 2, 128, 128, 32, True, [100, 0], 0.1, "pallas"),
    "decode_sq1": (4, 2, 1, 48, 16, False, [1, 17, 48, 0], None, "jnp"),
    "untiled_causal": (2, 3, 40, 40, 16, True, [40, 9], None, "jnp"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_matches_jax(case):
    B, H, S, Sk, D, causal, lens, scale, jax_impl = CASES[case]
    q, k, v = _qkv(B, H, S, Sk, D)
    kw = dict(causal=causal, scale=scale)
    ref = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl=jax_impl,
        kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32), **kw)
    got = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_lens=None if lens is None else torch.tensor(lens, dtype=torch.int32),
        **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if lens is not None and 0 in lens:
        row = lens.index(0)
        assert torch.all(got[row] == 0)  # fully masked rows are exactly 0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax(causal):
    BH, S, D = 4, 128, 32
    q, k, v = (a.reshape(BH, S, D) for a in _qkv(1, BH, S, S, D, seed=3))
    lens = np.array([128, 50, 0, 1], np.float32)
    ref_o, ref_lse = jattn.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=0.2, kv_lens=jnp.asarray(lens))
    got_o, got_lse = tattn.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=0.2, kv_lens=torch.from_numpy(lens))
    assert got_lse.shape == (BH, S) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(ref_lse), atol=ATOL,
                               rtol=1e-6)
    assert torch.all(got_lse[2] == -1e30)


@pytest.mark.parametrize("seq_len, head_dim", [(128, 64), (1024, 64), (1, 64),
                                               (384, 256), (2048, 16), (100, 4)])
def test_shape_gates_match_jax(seq_len, head_dim):
    assert (tattn.is_flash_available(seq_len, head_dim)
            == jattn.is_flash_available(seq_len, head_dim))
    assert (tattn._block_size(seq_len, head_dim)
            == jattn._block_size(seq_len, head_dim))


def test_flash_checks_arguments():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 8, 16))
    with pytest.raises(ValueError):  # causal needs matching lengths
        tattn.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError):  # (BH, S, D) is not the public layout
        tattn.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError):  # k/v mismatch
        tattn.flash_attention(q, k, v[:, :, :4])
    with pytest.raises(ValueError):  # a dropout rate needs a key
        tattn.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError):  # a key is an int64 (2,) tensor
        tattn.flash_attention(q, k, v, dropout_rate=0.1, dropout_key=0)
    with pytest.raises(ValueError):  # rates lie in [0, 1)
        tattn.flash_attention(q, k, v, dropout_rate=1.0,
                              dropout_key=torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("case", [c for c in CASES if c != "decode_sq1"])
def test_flash_backward_matches_jax(case):
    """dq, dk, dv through K4's plain path against JAX's Pallas dq/dkv
    kernels (or autodiff of its jnp oracle), fp32: atol 2e-5. Fully masked
    rows give exact zeros."""
    B, H, S, Sk, D, causal, lens, scale, jax_impl = CASES[case]
    q, k, v = _qkv(B, H, S, Sk, D)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, scale=scale)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def f(q, k, v):
        o = jattn.flash_attention(q, k, v, impl=jax_impl, kv_lens=jl, **kw)
        return jnp.sum(o * do)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tattn.flash_attention(
        tq, tk, tv,
        kv_lens=None if lens is None else torch.tensor(lens, dtype=torch.int32),
        **kw)
    (o * torch.from_numpy(do)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)
    if lens is not None and 0 in lens:
        row = lens.index(0)
        assert all(torch.all(t.grad[row] == 0) for t in (tq, tk, tv))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_backward_matches_jax(causal):
    """Differentiating through lse: the dlse term of ``_flash3_lse_bwd``."""
    BH, S, D = 4, 128, 32
    q, k, v = (a.reshape(BH, S, D) for a in _qkv(1, BH, S, S, D, seed=5))
    lens = np.array([128, 50, 0, 1], np.float32)
    rng = np.random.default_rng(8)
    do = rng.standard_normal((BH, S, D)).astype(np.float32)
    dl = rng.standard_normal((BH, S)).astype(np.float32)

    def f(q, k, v):
        o, lse = jattn.flash_attention_with_lse(
            q, k, v, causal=causal, scale=0.2, kv_lens=jnp.asarray(lens))
        return jnp.sum(o * do) + jnp.sum(jnp.where(lse > -1e29, lse, 0.0) * dl)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=causal, scale=0.2,
                                            kv_lens=torch.from_numpy(lens))
    live = torch.where(lse > -1e29, lse, 0.0)
    ((o * torch.from_numpy(do)).sum() + (live * torch.from_numpy(dl)).sum()).backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)


def test_flash_backward_without_lse_reads_no_dlse(monkeypatch):
    """An unused lse reaches the backward as None, so K4 gets no dlse."""
    seen = []
    real = tattn.flash_bwd_torch

    def spy(*args):
        seen.append(args[6])
        return real(*args)

    monkeypatch.setattr(tattn, "flash_bwd_torch", spy)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(1, 2, 8, 8, 16))
    tattn.flash_attention(q, k, v, causal=True).sum().backward()
    assert seen == [None]


def test_kernel_wrapper_refuses_cpu_tensors():
    """K2's wrapper launches on CUDA tensors or raises; it never falls back."""
    q, k, v = (torch.from_numpy(a).reshape(2, 8, 16)
               for a in _qkv(1, 2, 8, 8, 16))
    lens = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tattn.flash_fwd_kernel(q, k, v, lens, True, 0.25)
    with pytest.raises(ValueError):
        tattn.flash_attention_with_lse(q, k, v, causal=True, scale=0.25,
                                       impl="kernel")
    with pytest.raises(ValueError):
        tattn.flash_bwd_kernel(q, k, v, q, q, lens.float()[:, None].expand(2, 8),
                               None, lens, True, 0.25)


@pytest.mark.parametrize("D", [8, 40, 256, 512])
def test_every_gated_head_dim_matches_jax(D):
    """Head dims the gate admits beyond the tensor-core kernels' 16..128
    (K2/K4's CUDA-core row kernels take them on the card): the plain path
    against JAX's Pallas kernels (interpret mode), forward and backward,
    fp32."""
    assert tattn.is_flash_available(128, D) and jattn.is_flash_available(128, D)
    q, k, v = _qkv(1, 2, 128, 128, D, seed=D)
    do = np.random.default_rng(D).standard_normal(q.shape).astype(np.float32)
    lens = [128]

    def f(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=True, impl="pallas",
                                  kv_lens=jnp.asarray(lens, jnp.int32))
        return jnp.sum(o * do), o

    (_, ref), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tattn.flash_attention(tq, tk, tv, causal=True,
                              kv_lens=torch.tensor(lens, dtype=torch.int32))
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    for t, r in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-5)
