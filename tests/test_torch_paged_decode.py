"""Port parity: K2's paged decode mode (``ops/attention.py``
``_paged_decode_torch``, the plain version of ``_paged_decode_kernel``)
held against the JAX engine's decode attention, ``infer.kvcache.gather_pages``
followed by ``ops.flash_attention`` (its jnp path: one query row does not
tile the Pallas kernel), on the same numpy pools, page tables and lengths;
and a torch mirror of the decode kernel's split over the cache (chunks of
keys, partial ``(m, l, acc)`` per chunk, merged in chunk order) against
``flash_fwd_torch``. The kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.infer import kvcache as jkv
from beforeholiday_tpu.ops import attention as jattn
from beforeholiday_tpu_torch.ops import attention as tattn

B, H, PAGE, SLOTS = 3, 2, 4, 6
# lengths 0, 1, a full page (4), one key past it (5) and every slot (24),
# three sequences a case
LENS = [(0, 1, 4), (5, 24, 0), (24, 4, 1)]
NEG = -1e30


def _bf16_exact(a):
    """fp32 values a bf16 tensor widens to: what write_token stores."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _paged_inputs(D, lens, dtype, seed):
    """Pools of 1 + B * SLOTS pages (page 0 the null page, filled with noise
    that only masking keeps out), a shuffled table whose slots past each
    sequence's pages point at the null page, and q (B, 1, H*D)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * SLOTS
    pools = [rng.standard_normal((n_pages, PAGE, H * D)).astype(np.float32)
             for _ in range(2)]
    q = rng.standard_normal((B, 1, H * D)).astype(np.float32)
    if dtype == torch.bfloat16:
        pools = [_bf16_exact(p) for p in pools]
        q = _bf16_exact(q)
    pages = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((B, SLOTS), np.int32)
    for b, n in enumerate(lens):
        used = -(-n // PAGE)
        table[b, :used] = pages[b * SLOTS: b * SLOTS + used]
    return q, pools[0], pools[1], table, np.asarray(lens, np.int32)


def _jax_decode(q, kp, vp, table, lens, D, dtype):
    """The JAX engine's decode attention (engine.py, the fp32 pools): gather
    the pages, split the heads, flash_attention with the lengths."""
    jq = jnp.asarray(q)
    if dtype == torch.bfloat16:
        jq = jq.astype(jnp.bfloat16)
    kc = jkv.gather_pages(jnp.asarray(kp), jnp.asarray(table))
    vc = jkv.gather_pages(jnp.asarray(vp), jnp.asarray(table))

    def heads(t):
        return t.reshape(B, t.shape[1], H, D).transpose(0, 2, 1, 3)

    o = jattn.flash_attention(heads(jq), heads(kc), heads(vc), causal=False,
                              scale=D ** -0.5, kv_lens=jnp.asarray(lens))
    return np.asarray(o.astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(
        B, 1, H * D)


def _assert_within_one_bf16_ulp(got, ref):
    """Each bf16 output within one ulp of the other side's: both round one
    fp32 value, summed in another order."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    bad = np.abs(got - ref) > ulp
    assert not bad.any(), (f"{int(bad.sum())} elements beyond one bf16 ulp, "
                           f"worst {np.abs(got - ref).max()}")


@pytest.mark.parametrize("lens", LENS)
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_matches_jax_gather_and_flash(lens, D, dtype):
    q, kp, vp, table, ln = _paged_inputs(D, lens, dtype, seed=D + sum(lens))
    ref = _jax_decode(q, kp, vp, table, ln, D, dtype)
    o, lse = tattn._paged_decode_torch(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(ln), H, D ** -0.5)
    assert o.shape == (B, 1, H * D) and o.dtype == dtype
    assert lse.shape == (B * H, 1) and lse.dtype == torch.float32
    got = o.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    else:
        _assert_within_one_bf16_ulp(got, ref)
    for b, n in enumerate(lens):
        if n == 0:  # an empty sequence: o exactly 0, lse the mask fill
            assert np.all(got[b] == 0)
            assert torch.all(lse[b * H:(b + 1) * H] == NEG)


@pytest.mark.parametrize("kv_max", [0, 1, 4, 5, 23, 24, 100])
def test_paged_decode_kv_max_bounds_the_keys(kv_max):
    """kv_max, the engine's host-known bound: each sequence attends to its
    first min(kv_lens, kv_max) keys, as JAX's gather and flash attention do
    at the lengths so clamped."""
    D, lens = 16, (5, 24, 1)
    q, kp, vp, table, ln = _paged_inputs(D, lens, torch.float32, seed=9)
    ref = _jax_decode(q, kp, vp, table, np.minimum(ln, kv_max), D, torch.float32)
    o, lse = tattn._paged_decode_torch(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, ln)), H, D ** -0.5,
        kv_max=kv_max)
    np.testing.assert_allclose(o.numpy(), ref, atol=1e-5, rtol=0)
    if kv_max == 0:
        assert torch.all(o == 0) and torch.all(lse == NEG)


def test_paged_decode_refuses_a_negative_kv_max():
    q, kp, vp, table, ln = _paged_inputs(16, (5, 24, 1), torch.float32, seed=3)
    with pytest.raises(ValueError):
        tattn._paged_decode_torch(*(torch.from_numpy(a) for a in (q, kp, vp, table, ln)),
                                  H, 0.25, kv_max=-1)


def test_paged_decode_reads_the_pools_through_the_table():
    """Moving a sequence's pages elsewhere in the pool (and its table with
    them) leaves its output bitwise unchanged; the null page's contents
    never matter."""
    D, lens = 16, (5, 24, 1)
    q, kp, vp, table, ln = _paged_inputs(D, lens, torch.float32, seed=7)
    args = (torch.from_numpy(q),)
    o1, _ = tattn._paged_decode_torch(*args, torch.from_numpy(kp),
                                      torch.from_numpy(vp), torch.from_numpy(table),
                                      torch.from_numpy(ln), H, 0.25)
    perm = np.random.default_rng(8).permutation(np.arange(1, kp.shape[0]))
    inv = np.zeros(kp.shape[0], np.int64)
    inv[perm] = np.arange(1, kp.shape[0])
    moved = [np.concatenate([np.full_like(p[:1], 1e4), p[perm]]) for p in (kp, vp)]
    t2 = np.where(table > 0, inv[table], 0).astype(np.int32)
    o2, _ = tattn._paged_decode_torch(*args, torch.from_numpy(moved[0]),
                                      torch.from_numpy(moved[1]), torch.from_numpy(t2),
                                      torch.from_numpy(ln), H, 0.25)
    assert torch.equal(o1, o2)


# ------------------------------------------------- the split and its merge


def _chunked_decode(q, k, v, lens, scale, chunk, fold_empty=False):
    """A torch mirror of K2's decode path (``csrc/flash_fwd.cu``
    flash_decode_chunk_kernel and flash_decode_merge_kernel), non-causal: each
    live chunk of ``chunk`` keys gives a partial ``(m, l, acc)`` over its
    unmasked keys (m = -1e30, l = 0, acc = 0 where it has none), and the
    merge folds the live chunks in order: M = max m_c, L = sum exp(m_c - M)
    l_c, o = sum exp(m_c - M) acc_c / L, lse = M + log L (o = 0 and lse =
    -1e30 where L = 0). ``fold_empty`` folds every chunk of the cache,
    the empty ones past the lengths too."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    keys = torch.arange(Sk)
    n_all = -(-Sk // chunk)
    o = torch.zeros_like(q)
    lse = torch.full((BH, Sq), NEG)
    for bh in range(BH):
        n = min(max(int(lens[bh]), 0), Sk)
        live = n_all if fold_empty else -(-n // chunk)
        parts = []
        for c in range(live):
            sel = (keys >= c * chunk) & (keys < min((c + 1) * chunk, Sk))
            sel &= keys < n
            sc = s[bh][:, sel]
            if sc.shape[1] == 0:
                parts.append((torch.full((Sq,), NEG), torch.zeros(Sq),
                              torch.zeros(Sq, D)))
                continue
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), p @ v[bh][sel]))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = torch.zeros(Sq)
        acc = torch.zeros(Sq, D)
        for m, l, a in parts:
            w = torch.exp(m - M)
            L = L + w * l
            acc = acc + w[:, None] * a
        nonempty = L > 0
        o[bh] = torch.where(nonempty[:, None], acc / torch.where(nonempty, L, 1.0)[:, None], 0.0)
        lse[bh] = torch.where(nonempty, M + torch.log(torch.where(nonempty, L, 1.0)), NEG)
    return o, lse


@pytest.mark.parametrize("fold_empty", [False, True])
@pytest.mark.parametrize("Sq", [1, 3])
def test_chunked_merge_matches_flash_fwd_torch(Sq, fold_empty):
    """Chunk 8 over Sk 24: lengths at 0, 1, a chunk's edge, one past it, one
    short of the cache and the whole cache."""
    rng = np.random.default_rng(11 + Sq)
    lens = torch.tensor([0, 1, 8, 9, 16, 17, 23, 24], dtype=torch.int32)
    BH, Sk, D = len(lens), 24, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, s, D)).astype(np.float32))
               for s in (Sq, Sk, Sk))
    got_o, got_lse = _chunked_decode(q, k, v, lens, 0.3, 8, fold_empty)
    ref_o, ref_lse = tattn.flash_fwd_torch(q, k, v, lens, False, 0.3)
    torch.testing.assert_close(got_o, ref_o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_lse, ref_lse, rtol=1e-6, atol=1e-6)
    assert torch.all(got_o[0] == 0) and torch.all(got_lse[0] == NEG)


def test_paged_kernel_refuses_cpu_tensors():
    """The kernel wrapper launches on the card or raises: no CPU fallback."""
    q, kp, vp, table, ln = _paged_inputs(16, (5, 24, 1), torch.float32, seed=3)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, ln)]
    with pytest.raises(ValueError):
        tattn._paged_decode_kernel(*args, H, 0.25)
