"""Port parity: flash-attention forward (kernel K2's plain path), held against
the JAX package on the same numpy inputs. The JAX side runs its Pallas
kernel in interpret mode where the lengths tile by 128, and its jnp oracle
otherwise (decode's Sq=1 included)."""

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
    with pytest.raises(NotImplementedError):  # dropout is training-only
        tattn.flash_attention(q, k, v, dropout_rate=0.1, dropout_key=0)


def test_flash_backward_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 16))
    q.requires_grad_(True)
    o = tattn.flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError):
        o.sum().backward()


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
