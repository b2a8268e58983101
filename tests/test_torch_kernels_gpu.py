"""Kernels K1 and K3 (LayerNorm forward and backward, CUDA
C++), K2/K4 (flash attention forward/backward with dropout, CUDA C++), K5
(unscale), K6 (fused Adam), K7 (LAMB stage 1), K8 (trust-ratio update), K9
(global sum of squares), K10 (fused SGD) and K11/K12 (scaled masked softmax
forward/backward), all Triton, K13 (the dropout keep mask, CUDA C++) and
K14/K15 (the fused label-smoothing cross entropy forward/backward, Triton)
and K16-K18 (axpby, Adagrad, NovoGrad; Triton) against their plain PyTorch
versions on the card, and the engine and small O5 GPT (FusedAdam; flash and
unfused attention, with and without dropout, and with the fused cross
entropy as its loss), BERT (FusedLAMB; both attentions, with and without
dropout) and ResNet (FusedSGD, and FusedAdagrad, FusedNovoGrad, FusedLARS
and LARC on the list path) training steps on the kernels against the plain
path; K2/K4 at the TP 2 shape, and at a tensor world of one over NCCL the
tensor-parallel regions and layers and the TP GPT forward bitwise against
their dense counterparts.

Marked ``gpu``: without a CUDA device every test skips (the decision is made
inside the ``cuda`` fixture, never at import, so every pytest worker collects
the same tests). Run on an H100 with::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the repo's conftest imports JAX, which the card's machine
does not need.) Tolerances, and why, are tabulated in PERF.md.
"""

import dataclasses

import numpy as np
import pytest
import torch

from beforeholiday_tpu_torch import amp
from beforeholiday_tpu_torch.contrib import softmax_cross_entropy_loss
from beforeholiday_tpu_torch.contrib import xentropy as txent
from beforeholiday_tpu_torch.infer import EngineConfig, InferenceEngine, PageAllocator, pages_for
from beforeholiday_tpu_torch.ops import attention as tattn
from beforeholiday_tpu_torch.ops import multi_tensor as tmt
from beforeholiday_tpu_torch.ops import normalization as tnorm
from beforeholiday_tpu_torch.ops import softmax as tsm
from beforeholiday_tpu_torch.ops.arena import make_spec, tree_flatten
from beforeholiday_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedLARS,
    FusedNovoGrad,
    FusedSGD,
)
from beforeholiday_tpu_torch.testing import bert, gpt

pytestmark = pytest.mark.gpu

# bf16 outputs: kernel and plain version both compute in fp32 and round once,
# so they may differ by one bf16 ulp (relative 2**-7) where the fp32 values
# straddle a rounding boundary
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)
# fp16 outputs: the same one rounding at fp16's unit roundoff (8 times finer)
FP16_TOL = dict(rtol=2 ** -10, atol=2 ** -11)
FP32_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1-K18 run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("rows, hidden, dtype, rms, out_dtype, stride", [
    (8192, 1024, torch.bfloat16, False, torch.bfloat16, 1024),  # prefill
    (32, 1024, torch.bfloat16, False, torch.bfloat16, 1024),    # decode
    (300, 1024, torch.float32, False, torch.float32, 1024),
    (300, 1024, torch.float32, True, torch.float32, 1024),
    (77, 1000, torch.float32, False, torch.float32, 1000),      # odd width
    (64, 1000, torch.bfloat16, True, torch.float32, 1000),      # mixed dtype
    (300, 1024, torch.float16, False, torch.float16, 1024),     # amp O2
    (300, 1024, torch.bfloat16, False, torch.bfloat16, 1536),   # strided view
    (300, 1000, torch.bfloat16, False, torch.bfloat16, 1003),   # unaligned rows
    (40, 16384, torch.bfloat16, False, torch.bfloat16, 16384),  # widest row
    (40, 16384, torch.float32, True, torch.float32, 16384),
    (50, 1001, torch.float16, False, torch.float32, 1001),      # not a multiple of 8
])
@pytest.mark.parametrize("params", ["fp32", "x's dtype"])
def test_k1_matches_plain(cuda, rows, hidden, dtype, rms, out_dtype, stride, params):
    """K1 against its plain version, gamma and beta in fp32 (amp O5's
    training steps) or in x's dtype (the serving engine), and two calls
    bitwise equal."""
    g = _gen(0)
    base = (torch.randn(rows, stride, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    x = base[:, :hidden]
    pdt = torch.float32 if params == "fp32" else dtype
    w = (1 + 0.1 * torch.randn(hidden, generator=g, device=cuda)).to(pdt)
    b = None if rms else (0.1 * torch.randn(hidden, generator=g, device=cuda)).to(pdt)
    before = tnorm.ln_fwd_kernel.launches
    got = tnorm.ln_fwd_kernel(x, w, b, 1e-5, rms, out_dtype)
    assert tnorm.ln_fwd_kernel.launches == before + 1
    ref = tnorm.ln_fwd_torch(x, w, b, 1e-5, rms, out_dtype)
    again = tnorm.ln_fwd_kernel(x, w, b, 1e-5, rms, out_dtype)
    torch.cuda.synchronize()
    tol = {torch.bfloat16: BF16_TOL, torch.float16: FP16_TOL}.get(out_dtype, FP32_TOL)
    torch.testing.assert_close(got, ref, **tol)
    assert torch.equal(got, again)


def test_k1_rows_independent_of_the_call(cuda):
    """A row's bits depend on its values alone: decode's 32 rows alone are
    bitwise the same rows inside an 8192-row call, an unaligned view the
    same as its contiguous copy; an empty call launches nothing."""
    g = _gen(1)
    x = (torch.randn(8192, 1024, generator=g, device=cuda) * 2 + 0.5).bfloat16()
    w = 1 + 0.1 * torch.randn(1024, generator=g, device=cuda)
    b = 0.1 * torch.randn(1024, generator=g, device=cuda)
    whole = tnorm.ln_fwd_kernel(x, w, b, 1e-5, False, torch.bfloat16)
    for lo in (0, 4000, 8160):
        part = tnorm.ln_fwd_kernel(x[lo:lo + 32], w, b, 1e-5, False, torch.bfloat16)
        assert torch.equal(part, whole[lo:lo + 32])
    before = tnorm.ln_fwd_kernel.launches
    empty = tnorm.ln_fwd_kernel(x[:0], w, b, 1e-5, False, torch.bfloat16)
    assert empty.shape == (0, 1024) and tnorm.ln_fwd_kernel.launches == before
    # a view whose rows break 16-byte alignment takes plain loads: the same bits
    odd = (torch.randn(300, 1003, generator=g, device=cuda) * 2 + 0.5).bfloat16()[:, :1000]
    args = (w[:1000], b[:1000], 1e-5, False, torch.bfloat16)
    assert torch.equal(tnorm.ln_fwd_kernel(odd, *args),
                       tnorm.ln_fwd_kernel(odd.contiguous(), *args))


def test_k1_public_path_launches(cuda):
    x = torch.randn(4, 8, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    before = tnorm.ln_fwd_kernel.launches
    y = tnorm.fused_layer_norm(x, w, torch.zeros_like(w))
    assert tnorm.ln_fwd_kernel.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.bfloat16


# ------------------------------------------------------------------- K2


def _k2_inputs(BH, Sq, Sk, D, dtype, lens, seed=0):
    g = _gen(seed)
    q, k, v = (torch.randn(BH, s, D, generator=g, device="cuda").to(dtype)
               for s in (Sq, Sk, Sk))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device="cuda")


def _ragged(BH, full, seed=0):
    lens = np.random.default_rng(seed).integers(0, full + 1, BH)
    lens[0], lens[1] = 0, full
    return lens.tolist()


@pytest.mark.parametrize("BH, Sq, Sk, D, causal, dtype", [
    # decode kernel (Sq < 16)
    (512, 1, 1024, 64, False, torch.bfloat16),     # the engine's decode
    (16, 1, 300, 64, False, torch.float32),
    (8, 5, 5, 80, True, torch.bfloat16),
    (8, 15, 40, 128, False, torch.float32),
    # tensor-core kernel (bf16, Sq >= 16)
    (128, 1024, 1024, 64, True, torch.bfloat16),   # the engine's prefill
    (8, 70, 70, 48, True, torch.bfloat16),
    (8, 100, 100, 16, True, torch.bfloat16),
    (8, 64, 200, 128, False, torch.bfloat16),
    (4, 16, 16, 32, True, torch.bfloat16),
    (2048, 128, 128, 64, False, torch.bfloat16),   # BERT-Large, key padding
    # CUDA-core fp32 kernel (fp32, Sq >= 16)
    (16, 256, 256, 64, True, torch.float32),
    (8, 100, 100, 16, True, torch.float32),
    (8, 64, 200, 128, False, torch.float32),
    (8, 33, 33, 112, True, torch.float32),
    # fp16 (amp O1/O2): the tensor-core kernel, and the row kernel at head
    # dims it does not take
    (256, 1024, 1024, 64, True, torch.float16),    # the GPT training shape
    (2048, 128, 128, 64, False, torch.float16),    # BERT-Large, key padding
    (8, 70, 70, 48, True, torch.float16),
    (8, 200, 1000, 96, False, torch.float16),
    (8, 100, 100, 40, True, torch.float16),
    (8, 64, 64, 256, False, torch.float16),
])
def test_k2_matches_plain(cuda, BH, Sq, Sk, D, causal, dtype):
    q, k, v, lens = _k2_inputs(BH, Sq, Sk, D, dtype, _ragged(BH, Sk))
    scale = D ** -0.5
    before = tattn.flash_fwd_kernel.launches
    o, lse = tattn.flash_fwd_kernel(q, k, v, lens, causal, scale)
    assert tattn.flash_fwd_kernel.launches == before + 1
    ro, rlse = tattn.flash_fwd_torch(q, k, v, lens, causal, scale)
    torch.cuda.synchronize()
    assert torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)  # lens 0
    if dtype == torch.bfloat16:
        # K2 rounds each p to bf16 for its product with v: where the terms
        # cancel, that parts from the fp32 sum by up to 2^-9 sum p|v|, which
        # BF16_TOL does not follow (chip_smoke.py check_dropped_pv, PERF.md)
        ref_abs = tattn.flash_fwd_torch(q.float(), k.float(), v.float().abs(),
                                        lens, causal, scale)[0]
        assert bool(((o.float() - ro.float()).abs()
                     <= 2 ** -7 * ro.float().abs() + 2 ** -8 * ref_abs).all())
    elif dtype == torch.float16:
        assert bool(((o.float() - ro.float()).abs()
                     <= _fp16_pv_bound(q, k, v, lens, causal, scale, ro)).all())
    else:
        torch.testing.assert_close(o, ro, **FP32_TOL)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


def _fp16_pv_bound(q, k, v, lens, causal, scale, ro, rate=0.0, key=None):
    """K2's fp16 output bound, chip_smoke.py's check_dropped_pv in fp16's
    unit roundoff: 2^-10 |ref| + 2^-11 sum p|v| (each kept p rounded to fp16
    for p.v, the output rounded once), plus 2^-24 |v|max a live key for the
    p that fall below 2^-14, where fp16 is subnormal (an absolute step of
    2^-24)."""
    ref_abs = tattn.flash_fwd_torch(q.float(), k.float(), v.float().abs(),
                                    lens, causal, scale, rate, key)[0]
    vmax = v.float().abs().amax((1, 2))[:, None, None]
    keys = lens.float().clamp(max=k.shape[1])[:, None, None] / (1.0 - rate)
    return (2 ** -10 * ro.float().abs() + 2 ** -11 * ref_abs
            + 2 ** -24 * keys * vmax)


def test_k2_decode_and_paged_modes_refuse_fp16(cuda):
    """fp16 q has no decode path (Sq < 16) and no paged mode: both raise
    with a message naming fp16, rather than falling back."""
    for sq in (1, 5, 15):
        q, k, v, lens = _k2_inputs(4, sq, 64, 64, torch.float16, [64, 3, 0, 64])
        with pytest.raises(ValueError, match="float16"):
            tattn.flash_fwd_kernel(q, k, v, lens, False, 0.125)
    q, kp, vp, table, ln = _paged_pools(3, 2, 16, 9, 4, 2, [3, 8, 0],
                                        torch.float32, 1)
    with pytest.raises(ValueError, match="float16"):
        tattn._paged_decode_kernel(q.half(), kp, vp, table, ln, 2, 0.25)


@pytest.mark.parametrize("D, dtypes", [
    (4, (torch.float32,) * 3),                                   # head dim
    (64, (torch.bfloat16, torch.float32, torch.float32)),        # mixed
    (64, (torch.float16,) * 3),                                  # dtype
])
def test_k2_refuses_what_it_does_not_take(cuda, D, dtypes):
    q, k, v = (torch.zeros(2, 8, D, device=cuda, dtype=dt) for dt in dtypes)
    lens = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tattn.flash_fwd_kernel(q, k, v, lens, False, 0.1)


# ------------------------------------------------- K2's decode path (Sq < 16)


def _check_k2(q, k, v, lens, causal, scale, rate=0.0, key=None):
    """K2 against its plain version: bf16 at check_dropped_pv's bound (the
    decode path keeps p in fp32, inside it), fp32 at FP32_TOL, lse at rtol
    1e-5, atol 1e-4; a second call bitwise the first; lens 0 exactly 0."""
    before = tattn.flash_fwd_kernel.launches
    o, lse = tattn.flash_fwd_kernel(q, k, v, lens, causal, scale, rate, key)
    o2, lse2 = tattn.flash_fwd_kernel(q, k, v, lens, causal, scale, rate, key)
    assert tattn.flash_fwd_kernel.launches == before + 2
    ro, rlse = tattn.flash_fwd_torch(q, k, v, lens, causal, scale, rate, key)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "two calls differ"
    if q.dtype == torch.bfloat16:
        ref_abs = tattn.flash_fwd_torch(q.float(), k.float(), v.float().abs(),
                                        lens, causal, scale, rate, key)[0]
        assert bool(((o.float() - ro.float()).abs()
                     <= 2 ** -7 * ro.float().abs() + 2 ** -8 * ref_abs).all())
    else:
        torch.testing.assert_close(o, ro, **FP32_TOL)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    for row in (lens == 0).nonzero()[:, 0].tolist():
        assert torch.all(o[row] == 0) and torch.all(lse[row] == -1e30)


@pytest.mark.parametrize("Sq", range(1, 16))
@pytest.mark.parametrize("causal", [False, True])
def test_k2_decode_every_row_count(cuda, Sq, causal):
    """Every query-row count the decode path takes, causal and not, bf16 at
    odd counts and fp32 at even ones, ragged lengths over 600 keys (19
    chunks)."""
    dtype = torch.bfloat16 if Sq % 2 else torch.float32
    q, k, v, lens = _k2_inputs(24, Sq, 600, 64, dtype, _ragged(24, 600, Sq), seed=Sq)
    _check_k2(q, k, v, lens, causal, 0.125)


@pytest.mark.parametrize("Sk", [1000, 1024])
@pytest.mark.parametrize("Sq", [1, 5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_decode_lengths_at_the_chunk_edges(cuda, Sk, Sq, dtype):
    """Lengths 0, 1, a tile of 16 keys, a chunk of 32, one short of it and
    one past it, two chunks and around them, half the cache, the last key
    and every key; the chunks' partials merge in a fixed order, so two calls
    agree bitwise."""
    edges = [0, 1, 16, 31, 32, 33, 63, 64, 65, 511, 512, 513, Sk - 1, Sk]
    q, k, v, lens = _k2_inputs(len(edges), Sq, Sk, 64, dtype, edges, seed=Sk + Sq)
    _check_k2(q, k, v, lens, False, 0.125)


@pytest.mark.parametrize("D", range(16, 129, 16))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq", [1, 6])
def test_k2_decode_head_dims_with_dropout(cuda, D, dtype, Sq):
    """Every head dim of the decode path, dropout 0.1 at one key: the same
    Philox bits at (bh, row, key) as the plain version's mask."""
    q, k, v, lens = _k2_inputs(12, Sq, 530, D, dtype, _ragged(12, 530, D), seed=D)
    _check_k2(q, k, v, lens, False, D ** -0.5, 0.1, _key(D + Sq))


@pytest.mark.parametrize("Sk", [0, 1, 32])
@pytest.mark.parametrize("Sq", [1, 5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_decode_caches_of_one_chunk(cuda, Sk, Sq, dtype):
    """A cache of no key, one key or one whole chunk: one launch of the
    chunk kernel, no merge and no workspace; sk 0 gives o = 0 and lse =
    -1e30 on every row."""
    q, k, v, lens = _k2_inputs(6, Sq, Sk, 64, dtype, _ragged(6, Sk, Sk), seed=Sk)
    assert tattn.decode_workspace_floats(6, Sq, Sk, 64) == 0
    _check_k2(q, k, v, lens, False, 0.125)


@pytest.mark.parametrize("bh, sq, sk, d, floats", [
    (512, 1, 1024, 64, 512 * 32 * 66),  # the engine's decode shape
    (512, 1, 1025, 64, 512 * 33 * 66),  # one key past a chunk
    (16, 5, 300, 64, 16 * 5 * 10 * 66),
    (8, 15, 33, 128, 8 * 15 * 2 * 130),
    (8, 15, 32, 128, 0),                # one chunk writes o itself
    (8, 1, 0, 16, 0),                   # no keys: one (empty) chunk
    (8, 16, 64, 64, 0),                 # 16 rows take the tensor-core kernel
    (8, 1, 64, 8, 0),                   # head dim 8 takes the row kernel
    (8, 1, 64, 40, 0),
])
def test_decode_workspace_size(cuda, bh, sq, sk, d, floats):
    """The workspace the kernel source sizes: a partial (m, l, acc[d]) for
    each (bh, query row, chunk of 32 keys) where there is more than one
    chunk."""
    assert tattn.decode_workspace_floats(bh, sq, sk, d) == floats


def _paged_pools(B, H, D, n_pages, page, slots, lens, dtype, seed,
                 pool_dtype=torch.float32):
    """Pools of ``pool_dtype`` holding values of q's dtype (as write_token
    stores them), a shuffled table with null slots past each sequence's
    pages, and q as the QKV projection leaves it: a (B, 1, H*D) chunk of a
    (B, 1, 3*H*D) tensor."""
    g = _gen(seed)
    pools = [torch.randn(n_pages, page, H * D, generator=g, device="cuda")
             .to(dtype).to(pool_dtype) for _ in range(2)]
    qkv = torch.randn(B, 1, 3 * H * D, generator=g, device="cuda").to(dtype)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros(B, slots, dtype=torch.int32)
    for b, n in enumerate(lens):
        used = -(-n // page)
        table[b, :used] = perm[b * slots: b * slots + used]
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return qkv.chunk(3, dim=-1)[0], pools[0], pools[1], table.cuda(), lens


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_equals_contiguous_mode(cuda, D, dtype):
    """The paged mode against the contiguous mode on the gathered, narrowed
    copies: bitwise, twice; against the plain version at K2's bounds;
    lengths 0 exactly 0. The engine's decode shape at D 64 (B 32, H 16,
    2049 pages of 16, 64 slots)."""
    B, H = (32, 16) if D == 64 else (6, 4)
    lens = _ragged(B, 1024, D)
    lens[2:6] = [1, 16, 17, 32]
    q, kp, vp, table, ln = _paged_pools(B, H, D, 2049, 16, 64, lens, dtype, D)
    before = tattn._paged_decode_kernel.launches
    o, lse = tattn._paged_decode_kernel(q, kp, vp, table, ln, H, D ** -0.5)
    o2, lse2 = tattn._paged_decode_kernel(q, kp, vp, table, ln, H, D ** -0.5)
    assert tattn._paged_decode_kernel.launches == before + 2
    heads = lambda t: (t.reshape(B, t.shape[1], H, D).transpose(1, 2)
                       .reshape(B * H, t.shape[1], D).contiguous())
    from beforeholiday_tpu_torch.infer.kvcache import gather_pages
    kc, vc = (heads(gather_pages(p, table).to(dtype)) for p in (kp, vp))
    co, clse = tattn.flash_fwd_kernel(heads(q), kc, vc, ln.repeat_interleave(H),
                                      False, D ** -0.5)
    ro, rlse = tattn._paged_decode_torch(q, kp, vp, table, ln, H, D ** -0.5)
    torch.cuda.synchronize()
    assert o.shape == (B, 1, H * D) and o.dtype == dtype
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "two calls differ"
    assert torch.equal(heads(o), co) and torch.equal(lse, clse)
    if dtype == torch.bfloat16:
        ref_abs = tattn._paged_decode_torch(q.float(), kp, vp.abs(), table, ln, H,
                                            D ** -0.5)[0]
        assert bool(((o.float() - ro.float()).abs()
                     <= 2 ** -7 * ro.float().abs() + 2 ** -8 * ref_abs).all())
    else:
        torch.testing.assert_close(o, ro, **FP32_TOL)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    assert torch.all(o[0] == 0) and torch.all(lse[:H] == -1e30)


@pytest.mark.parametrize("kv_max", [0, 1, 16, 32, 33, 100, 1023, 1024, 5000])
def test_paged_decode_kv_max_sizes_the_grid(cuda, kv_max):
    """kv_max, the engine's host-known bound on the lengths, launches the
    chunks below it only: bitwise the whole table's grid on the lengths
    clamped at it, and the plain version's at K2's bounds; a bound past the
    table reads the table."""
    B, H, D = 8, 4, 64
    lens = [0, 1, 16, 32, 33, 100, 700, 1024]
    q, kp, vp, table, ln = _paged_pools(B, H, D, 1 + B * 64, 16, 64, lens,
                                        torch.bfloat16, 5)
    o, lse = tattn._paged_decode_kernel(q, kp, vp, table, ln, H, 0.125,
                                        kv_max=kv_max)
    wo, wlse = tattn._paged_decode_kernel(q, kp, vp, table, ln.clamp(max=kv_max),
                                          H, 0.125)
    ro, rlse = tattn._paged_decode_torch(q, kp, vp, table, ln, H, 0.125,
                                         kv_max=kv_max)
    ref_abs = tattn._paged_decode_torch(q.float(), kp, vp.abs(), table, ln, H,
                                        0.125, kv_max=kv_max)[0]
    torch.cuda.synchronize()
    assert torch.equal(o, wo) and torch.equal(lse, wlse)
    assert bool(((o.float() - ro.float()).abs()
                 <= 2 ** -7 * ro.float().abs() + 2 ** -8 * ref_abs).all())
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    if kv_max == 0:
        assert torch.all(o == 0) and torch.all(lse == -1e30)


def test_paged_decode_empty_table(cuda):
    """A table of no slot (sk 0): every sequence empty, o = 0 and lse =
    -1e30, no table entry read."""
    q, kp, vp, table, ln = _paged_pools(3, 2, 16, 9, 4, 0, [0, 0, 0],
                                        torch.float32, 2)
    o, lse = tattn._paged_decode_kernel(q, kp, vp, table, ln, 2, 0.25)
    torch.cuda.synchronize()
    assert torch.all(o == 0) and torch.all(lse == -1e30)


@pytest.mark.parametrize("what", ["int64_table", "fp16_q", "two_rows", "head_dim_8",
                                  "bf16_pool", "strided_pool", "negative_kv_max"])
def test_paged_decode_refuses_what_it_does_not_take(cuda, what):
    H, D = 2, 8 if what == "head_dim_8" else 16
    q, kp, vp, table, ln = _paged_pools(3, H, D, 9, 4, 2, [3, 8, 0],
                                        torch.float32, 1)
    kw = {"kv_max": -1} if what == "negative_kv_max" else {}
    if what == "int64_table":
        table = table.long()
    elif what == "fp16_q":
        q = q.half()
    elif what == "two_rows":
        q = torch.cat([q, q], 1)
    elif what == "bf16_pool":  # beside an fp32 v pool: two dtypes
        kp = kp.bfloat16()
    elif what == "strided_pool":
        kp = kp.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        tattn._paged_decode_kernel(q, kp, vp, table, ln, H, 0.25, **kw)


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.float16])
def test_paged_decode_on_16bit_pools(cuda, D, dtype, pool_dtype):
    """bf16 and fp16 pools read in place: bitwise the contiguous mode on
    the gathered copy converted to q's dtype, twice bitwise, the plain
    version at K2's bounds, lengths 0 exactly 0; and, since the arithmetic
    follows q's dtype alone, bitwise the launch over fp32 pools holding the
    same values (every bf16 value, and every fp16 value read for fp32 q, is
    an fp32 value; fp16 read for bf16 q rounds once, as the fp32 pool
    holding the fp16 values rounds it)."""
    B, H = (32, 16) if D == 64 else (6, 4)
    lens = _ragged(B, 1024, D + 1)
    lens[2:6] = [1, 16, 17, 32]
    q, kp, vp, table, ln = _paged_pools(B, H, D, 2049, 16, 64, lens, dtype, D,
                                        pool_dtype)
    scale = D ** -0.5
    before = tattn._paged_decode_kernel.launches
    o, lse = tattn._paged_decode_kernel(q, kp, vp, table, ln, H, scale)
    o2, lse2 = tattn._paged_decode_kernel(q, kp, vp, table, ln, H, scale)
    wide = tattn._paged_decode_kernel(q, kp.float(), vp.float(), table, ln, H,
                                      scale)
    assert tattn._paged_decode_kernel.launches == before + 3
    heads = lambda t: (t.reshape(B, t.shape[1], H, D).transpose(1, 2)
                       .reshape(B * H, t.shape[1], D).contiguous())
    from beforeholiday_tpu_torch.infer.kvcache import gather_pages
    kc, vc = (heads(gather_pages(p, table).to(dtype)) for p in (kp, vp))
    co, clse = tattn.flash_fwd_kernel(heads(q), kc, vc, ln.repeat_interleave(H),
                                      False, scale)
    ro, rlse = tattn._paged_decode_torch(q, kp, vp, table, ln, H, scale)
    torch.cuda.synchronize()
    assert o.shape == (B, 1, H * D) and o.dtype == dtype
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "two calls differ"
    assert torch.equal(heads(o), co) and torch.equal(lse, clse)
    assert torch.equal(o, wide[0]) and torch.equal(lse, wide[1])
    if dtype == torch.bfloat16:
        ref_abs = tattn._paged_decode_torch(q.float(), kp, vp.abs(), table, ln, H,
                                            scale)[0]
        assert bool(((o.float() - ro.float()).abs()
                     <= 2 ** -7 * ro.float().abs() + 2 ** -8 * ref_abs).all())
    else:
        torch.testing.assert_close(o, ro, **FP32_TOL)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    assert torch.all(o[0] == 0) and torch.all(lse[:H] == -1e30)


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float16"])
def test_engine_16bit_pages_read_in_place(cuda, cache_dtype, monkeypatch):
    """A bf16 engine on bf16 or fp16 pages: each decode call launches the
    paged mode once a layer and gathers no page; on bf16 pages the logits
    are bitwise those on fp32 pages (the pages hold the same bf16 values,
    the kernel computes the same), on fp16 pages within 0.1."""
    from beforeholiday_tpu_torch.infer import kvcache

    cfg = gpt.GPTConfig(vocab_size=512, seq_len=256, d_model=128, n_heads=2,
                        n_layers=2, dtype=torch.bfloat16)
    params = gpt.init(cfg, _gen(3), device=cuda)
    kw = dict(max_seq_len=256, page_size=16, num_pages=49, batch_buckets=(4,),
              prefill_seq_buckets=(128, 256), weights_dtype="bfloat16")
    engines = {d: InferenceEngine(params, cfg, EngineConfig(**kw, cache_dtype=d))
               for d in ("float32", cache_dtype)}
    assert (engines["float32"].layout.page_bytes
            == 2 * engines[cache_dtype].layout.page_bytes)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (200, 1, 97)]
    alloc = PageAllocator(kw["num_pages"])
    tables = [alloc.alloc(pages_for(len(p) + 4, 16)) for p in prompts]
    toks = engines["float32"].prefill(prompts, tables).tolist()
    engines[cache_dtype].prefill(prompts, tables)
    gathers = []
    real_gather = kvcache.gather_pages
    monkeypatch.setattr(kvcache, "gather_pages",
                        lambda *a: gathers.append(1) or real_gather(*a))
    lens = [len(p) for p in prompts]
    for _ in range(4):
        paged = tattn._paged_decode_kernel.launches
        got = engines[cache_dtype].decode_logits(toks, lens, tables)
        assert tattn._paged_decode_kernel.launches - paged == cfg.n_layers
        ref = engines["float32"].decode_logits(toks, lens, tables)
        assert not gathers and np.isfinite(got).all()
        if cache_dtype == "bfloat16":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=0.1, rtol=0)
        toks = ref.argmax(-1).tolist()
        lens = [n + 1 for n in lens]


def test_engine_kernels_match_plain_path(cuda):
    """A bf16 engine on K1/K2 against the same weights on the plain path:
    logits per step within a bf16 tolerance, both fed the same tokens."""
    cfg = gpt.GPTConfig(vocab_size=512, seq_len=128, d_model=128, n_heads=4,
                        n_layers=2, dtype=torch.bfloat16)
    params = gpt.init(cfg, _gen(0), device=cuda)
    ecfg = EngineConfig(max_seq_len=128, page_size=16, num_pages=33,
                        batch_buckets=(2, 4), prefill_seq_buckets=(32, 64, 128),
                        weights_dtype="bfloat16")
    engines = {impl: InferenceEngine(params, cfg, ecfg, impl=impl)
               for impl in ("kernel", "torch")}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).tolist() for n in (40, 7, 100)]
    alloc = PageAllocator(ecfg.num_pages)
    tables = [alloc.alloc(pages_for(len(p) + 4, 16)) for p in prompts]
    k1, k2 = tnorm.ln_fwd_kernel.launches, tattn.flash_fwd_kernel.launches
    first = {i: e.prefill(prompts, tables) for i, e in engines.items()}
    assert tnorm.ln_fwd_kernel.launches - k1 == 2 * cfg.n_layers + 1
    assert tattn.flash_fwd_kernel.launches - k2 == cfg.n_layers
    # prefill tokens are compared through the next step's logits: a near tie
    # in random weights may flip an argmax without any kernel fault
    toks, lens = first["kernel"].tolist(), [len(p) for p in prompts]
    for _ in range(4):
        logits = {i: e.decode_logits(toks, lens, tables)
                  for i, e in engines.items()}
        np.testing.assert_allclose(logits["kernel"], logits["torch"],
                                   atol=2e-2, rtol=0)
        toks = logits["kernel"].argmax(-1).tolist()
        lens = [n + 1 for n in lens]


def test_engine_decode_reads_pages_in_place(cuda, monkeypatch):
    """On the kernels each decode call launches the paged mode once a layer
    and gathers no page; the plain engine gathers, narrows and runs the
    contiguous plain path, and the two agree."""
    from beforeholiday_tpu_torch.infer import kvcache

    cfg = gpt.GPTConfig(vocab_size=512, seq_len=512, d_model=128, n_heads=2,
                        n_layers=2, dtype=torch.bfloat16)
    params = gpt.init(cfg, _gen(1), device=cuda)
    ecfg = EngineConfig(max_seq_len=512, page_size=16, num_pages=97,
                        batch_buckets=(4,), prefill_seq_buckets=(128, 512),
                        weights_dtype="bfloat16")
    engines = {impl: InferenceEngine(params, cfg, ecfg, impl=impl)
               for impl in ("kernel", "torch")}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).tolist() for n in (300, 1, 257)]
    alloc = PageAllocator(ecfg.num_pages)
    tables = [alloc.alloc(pages_for(len(p) + 2, 16)) for p in prompts]
    toks = {i: e.prefill(prompts, tables) for i, e in engines.items()}
    gathers = []
    real_gather = kvcache.gather_pages
    monkeypatch.setattr(kvcache, "gather_pages",
                        lambda *a: gathers.append(1) or real_gather(*a))
    lens = [len(p) for p in prompts]
    paged, flash = tattn._paged_decode_kernel.launches, tattn.flash_fwd_kernel.launches
    got = engines["kernel"].decode_logits(toks["kernel"].tolist(), lens, tables)
    assert tattn._paged_decode_kernel.launches - paged == cfg.n_layers
    assert tattn.flash_fwd_kernel.launches == flash and not gathers
    ref = engines["torch"].decode_logits(toks["kernel"].tolist(), lens, tables)
    assert len(gathers) == 2 * cfg.n_layers
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)


@pytest.mark.parametrize("n_heads, d_model", [(4, 32), (2, 512)])
def test_engine_decodes_head_dims_off_the_decode_path(cuda, n_heads, d_model):
    """Head dims 8 and 256, which K2's decode path is not built for, decode
    on the contiguous K2 (its row kernel) over the gathered copy: one launch
    a layer and no paged one, logits as the plain engine's."""
    cfg = gpt.GPTConfig(vocab_size=512, seq_len=128, d_model=d_model,
                        n_heads=n_heads, n_layers=2, dtype=torch.bfloat16)
    params = gpt.init(cfg, _gen(2), device=cuda)
    ecfg = EngineConfig(max_seq_len=128, page_size=16, num_pages=33,
                        batch_buckets=(4,), prefill_seq_buckets=(32, 128),
                        weights_dtype="bfloat16")
    engines = {impl: InferenceEngine(params, cfg, ecfg, impl=impl)
               for impl in ("kernel", "torch")}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).tolist() for n in (20, 1, 90)]
    alloc = PageAllocator(ecfg.num_pages)
    tables = [alloc.alloc(pages_for(len(p) + 3, 16)) for p in prompts]
    toks = engines["kernel"].prefill(prompts, tables).tolist()
    engines["torch"].prefill(prompts, tables)
    lens = [len(p) for p in prompts]
    for _ in range(3):
        paged, flash = (tattn._paged_decode_kernel.launches,
                        tattn.flash_fwd_kernel.launches)
        got = engines["kernel"].decode_logits(toks, lens, tables)
        assert tattn._paged_decode_kernel.launches == paged
        assert tattn.flash_fwd_kernel.launches - flash == cfg.n_layers
        ref = engines["torch"].decode_logits(toks, lens, tables)
        assert got.shape == (3, 512) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
        toks = got.argmax(-1).tolist()
        lens = [n + 1 for n in lens]


# ------------------------------------------------------------------- K3

# dgamma/dbeta sum over every row in fp32 in another order than the plain
# version: absolute error grows with the row count
DW_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("rows, hidden, dtype, rms, bias", [
    (16384, 1024, torch.bfloat16, False, True),   # the training shape (O5 mix)
    (300, 1024, torch.float32, False, True),
    (300, 1024, torch.float32, True, False),
    (77, 1000, torch.float32, False, True),       # odd rows and width
    (64, 1000, torch.bfloat16, True, False),
    (5, 48, torch.bfloat16, False, False),
    (2048, 768, torch.bfloat16, False, True),     # the widths a team of warps takes
    (2048, 768, torch.float32, False, True),
    (1024, 4096, torch.bfloat16, False, True),
    (1024, 4096, torch.float32, True, False),
    (128, 16384, torch.bfloat16, False, True),
    (128, 16384, torch.float32, False, True),
    (33, 77, torch.float32, False, True),         # rows not 16-byte aligned
])
def test_k3_matches_plain(cuda, rows, hidden, dtype, rms, bias):
    """dx within one rounding, dgamma/dbeta within the fp32 sums' order; a
    second call gives the same bits (no atomics)."""
    g = _gen(1)
    x = (torch.randn(rows, hidden, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    dy = torch.randn(rows, hidden, generator=g, device=cuda).to(dtype)
    w = 1 + 0.1 * torch.randn(hidden, generator=g, device=cuda)
    before = tnorm.ln_bwd_kernel.launches
    dx, dw, db = tnorm.ln_bwd_kernel(x, w, dy, 1e-5, rms, bias)
    assert tnorm.ln_bwd_kernel.launches == before + 1
    dx2, dw2, db2 = tnorm.ln_bwd_kernel(x, w, dy, 1e-5, rms, bias)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert not bias or torch.equal(db, db2)
    rdx, rdw, rdb = tnorm.ln_bwd_torch(x, w, dy, 1e-5, rms)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dw.dtype == torch.float32
    torch.testing.assert_close(dx, rdx, **(BF16_TOL if dtype == torch.bfloat16
                                           else FP32_TOL))
    torch.testing.assert_close(dw, rdw, **DW_TOL)
    if bias:
        torch.testing.assert_close(db, rdb, **DW_TOL)
    else:
        assert db is None


# ------------------------------------------------------------------- K4


def _k4_tol(dtype, ref):
    # bf16: the tensor-core kernel rounds p and ds to bf16 for its products
    # (as the TPU kernel does); the plain version keeps them fp32. fp16: the
    # same form at fp16's unit roundoff, 8 times finer
    if dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2 * float(ref.float().abs().max()))
    if dtype == torch.float16:
        return dict(rtol=2.5e-3, atol=2.5e-3 * float(ref.float().abs().max()))
    return dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("BH, Sq, Sk, D, causal, dtype, dlse", [
    (256, 1024, 1024, 64, True, torch.bfloat16, False),  # the training shape
    (2048, 128, 128, 64, False, torch.bfloat16, False),  # BERT-Large, padding
    (8, 70, 70, 48, True, torch.bfloat16, True),
    (8, 64, 200, 128, False, torch.bfloat16, False),
    (8, 100, 100, 80, True, torch.bfloat16, True),
    (16, 256, 256, 64, True, torch.float32, False),
    (8, 100, 100, 80, True, torch.float32, True),
    (8, 33, 70, 128, False, torch.float32, True),
    (4, 16, 16, 16, True, torch.float32, False),
    (256, 1024, 1024, 64, True, torch.float16, False),  # GPT at O1/O2
    (2048, 128, 128, 64, False, torch.float16, False),
    (8, 70, 70, 48, True, torch.float16, True),
    (8, 100, 100, 40, False, torch.float16, True),      # the row kernels
])
def test_k4_matches_plain(cuda, BH, Sq, Sk, D, causal, dtype, dlse):
    q, k, v, lens = _k2_inputs(BH, Sq, Sk, D, dtype, _ragged(BH, Sk), seed=3)
    scale = D ** -0.5
    o, lse = tattn.flash_fwd_torch(q, k, v, lens, causal, scale)
    g = _gen(4)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    dl = torch.randn(lse.shape, generator=g, device=cuda) if dlse else None
    before = tattn.flash_bwd_kernel.launches
    got = tattn.flash_bwd_kernel(q, k, v, o, do, lse, dl, lens, causal, scale)
    assert tattn.flash_bwd_kernel.launches == before + 1
    ref = tattn.flash_bwd_torch(q, k, v, o, do, lse, dl, lens, causal, scale)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, **_k4_tol(dtype, b), msg=name)
    # lens = 0: exact zeros, never NaN
    assert all(torch.all(t[0] == 0) for t in got)


def test_flash_autograd_runs_k4(cuda):
    q, k, v, lens = _k2_inputs(4, 64, 64, 32, torch.bfloat16, [64, 10, 0, 64])
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = tattn.flash_bwd_kernel.launches
    o, lse = tattn.flash_attention_with_lse(q, k, v, causal=True, scale=0.2,
                                            kv_lens=lens)
    (o.float().square().sum() + lse[:, :3].sum()).backward()
    assert tattn.flash_bwd_kernel.launches == before + 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# ------------------------------------------------------------------- K5


@pytest.mark.parametrize("n, dtype, poison", [
    (4 * 32768, torch.bfloat16, None),
    (4 * 32768, torch.bfloat16, float("inf")),
    (100003, torch.float32, float("nan")),
    (100003, torch.float32, None),
])
def test_k5_matches_plain(cuda, n, dtype, poison):
    x = torch.randn(n, generator=_gen(5), device=cuda).to(dtype)
    if poison is not None:
        x[n // 2] = poison
    scale = torch.full((), 1 / 1024, device=cuda)
    before = tmt.scale_kernel.launches
    y, flag = tmt.scale_kernel(x, scale, torch.float32)
    assert tmt.scale_kernel.launches == before + 1
    ry, rflag = tmt.scale_torch(x, scale, torch.float32)
    torch.cuda.synchronize()
    assert bool(flag) == bool(rflag) == (poison is not None)
    assert torch.equal(y, ry) if poison is None else torch.equal(
        y.isnan(), ry.isnan())


def test_k5_flags_an_overflowing_output(cuda):
    x = torch.full((1000,), 3e38, device=cuda)
    _, flag = tmt.scale_kernel(x, 2.0, torch.float32)
    assert bool(flag)


# ------------------------------------------------------------------- K6


@pytest.mark.parametrize("n, adam_w, bc, copy, skip", [
    (4 * 32768, True, True, torch.bfloat16, False),
    (100003, False, True, None, False),
    (100003, True, False, torch.float32, False),
    (4 * 32768, True, True, torch.bfloat16, True),
])
def test_k6_matches_plain(cuda, n, adam_w, bc, copy, skip):
    g = _gen(6)
    grad = torch.randn(n, generator=g, device=cuda)
    p = torch.randn(n, generator=g, device=cuda)
    m = 0.1 * torch.randn(n, generator=g, device=cuda)
    v = 0.01 * torch.rand(n, generator=g, device=cuda)
    step = torch.full((), 3, dtype=torch.int32, device=cuda)
    found = torch.full((), skip, dtype=torch.bool, device=cuda)
    outs = {}
    for impl in ("kernel", "torch"):
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        ck = None if copy is None else torch.zeros(n, dtype=copy, device=cuda)
        tmt.adam_flat(grad, pk, mk, vk, lr=1e-3, step=step, adam_w_mode=adam_w,
                      bias_correction=bc, weight_decay=0.01, grad_scale=0.5,
                      found_inf=found, model_copy=ck, impl=impl)
        outs[impl] = (pk, mk, vk, ck)
    torch.cuda.synchronize()
    if skip:  # bitwise untouched
        assert torch.equal(outs["kernel"][0], p) and torch.equal(outs["kernel"][1], m)
        assert torch.equal(outs["kernel"][2], v)
        if copy is not None:
            assert torch.equal(outs["kernel"][3], torch.zeros_like(outs["kernel"][3]))
        return
    for a, b in zip(outs["kernel"], outs["torch"]):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert torch.equal(outs["kernel"][3], outs["kernel"][0].to(copy)) \
        if copy is not None else True


# ------------------------------------------------------- training step


def test_training_step_kernels_match_plain_path(cuda):
    """One O5 arena-native step of a 2-layer bf16 GPT on K1-K6 against the
    same step with every op on its plain version."""
    base = dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4,
                n_layers=2, dtype=torch.bfloat16)
    params = gpt.init(gpt.GPTConfig(**base), _gen(0), device=cuda)
    tok, tgt = gpt.synthetic_batch(gpt.GPTConfig(**base), 2, generator=_gen(1),
                                   device=cuda)
    res = {}
    for impl in ("kernel", "torch"):
        cfg = gpt.GPTConfig(**base, attention_impl=impl, norm_impl=impl)
        m = amp.initialize(lambda p, t, cfg=cfg: gpt.forward(p, t, cfg), params,
                           FusedAdam(lr=1e-3, impl=impl), "O5", arena_native=True)
        svag = amp.scaled_value_and_grad(
            lambda p, a, b, cfg=cfg, m=m: gpt.loss_fn(p, a, b, cfg,
                                                      forward_fn=m.apply),
            m.scaler, impl=impl)
        o, s = m.optimizer.init(m.params), m.scaler.init()
        counts = (tnorm.ln_bwd_kernel.launches, tattn.flash_bwd_kernel.launches,
                  tmt.scale_kernel.launches, tmt.adam_kernel.launches)
        loss, g, fi, s = svag(m.params, s, tok, tgt)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(
            (tnorm.ln_bwd_kernel.launches, tattn.flash_bwd_kernel.launches,
             tmt.scale_kernel.launches, tmt.adam_kernel.launches), counts)]
        assert launched == ([5, 2, 2, 2] if impl == "kernel" else [0, 0, 0, 0])
        res[impl] = (loss, g.arenas, o["master"], m.params.arenas)
    (lk, gk, mk, pk), (lt, gt, mt_, pt) = res["kernel"], res["torch"]
    torch.testing.assert_close(lk, lt, rtol=2e-3, atol=0)
    for a, b in zip(gk, gt):
        torch.testing.assert_close(a, b, rtol=0.05, atol=2e-2 * float(b.abs().max()))
    for a, b in zip(mk, mt_):
        torch.testing.assert_close(a, b, rtol=0, atol=2.5e-3)  # up to 2 lr
    for arena, master in zip(pk, mk):
        assert torch.equal(arena, master.to(arena.dtype))


# ------------------------------------------------------------------- K9


@pytest.mark.parametrize("n, dtype, scale, poison", [
    (4 * 32768, torch.float32, None, None),
    (100003, torch.float32, 1 / 1024, None),
    (4099, torch.bfloat16, None, None),
    (100003, torch.float32, None, float("inf")),
    (4097, torch.bfloat16, 0.5, float("nan")),
    (1, torch.float32, None, None),
])
def test_k9_matches_plain(cuda, n, dtype, scale, poison):
    x = torch.randn(n, generator=_gen(9), device=cuda).to(dtype)
    if poison is not None:
        x[n // 2] = poison
    s = None if scale is None else torch.full((), scale, device=cuda)
    before = tmt.l2norm_sq_kernel.launches
    sq, flag = tmt.l2norm_sq_kernel(x, s)
    assert tmt.l2norm_sq_kernel.launches == before + 1
    rsq, rflag = tmt.l2norm_sq_torch(x, s)
    torch.cuda.synchronize()
    assert sq.shape == () and sq.dtype == torch.float32
    assert bool(flag) == bool(rflag) == (poison is not None)
    if poison is None:
        torch.testing.assert_close(sq, rsq, rtol=1e-5, atol=0)


def test_k9_is_bitwise_reproducible(cuda):
    """Two-stage reduction, no float atomics: the same input gives the same
    bits on every call."""
    x = torch.randn(3 * 1024 * 4096 + 7, generator=_gen(10), device=cuda)
    first, _ = tmt.l2norm_sq_kernel(x)
    for _ in range(3):
        again, _ = tmt.l2norm_sq_kernel(x)
        assert torch.equal(first, again)


# ------------------------------------------------------------------- K7


@pytest.mark.parametrize("n, mode, clip, skip", [
    (4 * 32768, 1, 2.5, False),
    (100003, 0, 1.0, False),
    (100003, 1, 3.0, True),
    (5, 0, 1.0, False),
])
def test_k7_matches_plain(cuda, n, mode, clip, skip):
    g = _gen(7)
    grad = torch.randn(n, generator=g, device=cuda)
    if skip:
        grad[n // 2] = float("inf")
    p = torch.randn(n, generator=g, device=cuda)
    m = 0.1 * torch.randn(n, generator=g, device=cuda)
    v = 0.01 * torch.rand(n, generator=g, device=cuda)
    step = torch.full((), 3, dtype=torch.int32, device=cuda)
    bc1, bc2 = tmt._bias_corrections(True, step, 0.9, 0.999)
    kw = dict(beta1=0.9, beta2=0.999, beta3=0.1, bc1=bc1, bc2=bc2, eps=1e-6,
              weight_decay=0.01, clip=torch.full((), clip, device=cuda),
              mode=mode,
              found_inf=torch.full((), skip, dtype=torch.bool, device=cuda))
    outs = {}
    for fn in (tmt.lamb_stage1_kernel, tmt.lamb_stage1_torch):
        mk, vk = m.clone(), v.clone()
        outs[fn] = (fn(grad, p, mk, vk, **kw), mk, vk)
    torch.cuda.synchronize()
    got, ref = outs[tmt.lamb_stage1_kernel], outs[tmt.lamb_stage1_torch]
    if skip:  # u = 0, moments bitwise held
        assert torch.all(got[0] == 0)
        assert torch.equal(got[1], m) and torch.equal(got[2], v)
        return
    # a few ulp where the compiler contracts a multiply-add; where the terms
    # of u (or of m) cancel, those ulp are the largest term's
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


# ------------------------------------------------------------------- K8


AWKWARD = [(1,), (4095,), (3, 5), (4097,), (70000,), (1,), (8193,), (2, 2)]


@pytest.mark.parametrize("copy, skip", [
    (torch.bfloat16, False), (torch.float32, False), (None, False),
    (torch.bfloat16, True),
])
def test_k8_matches_plain(cuda, copy, skip):
    spec = make_spec(AWKWARD)
    n = spec.padded_total
    g = _gen(8)
    p = torch.randn(n, generator=g, device=cuda)
    p[spec.total:] = 0
    u = torch.randn(n, generator=g, device=cuda)  # non-zero on the padding
    ratio = 1e-3 * (0.5 + torch.rand(spec.num_tensors, generator=g, device=cuda))
    found = torch.full((), skip, dtype=torch.bool, device=cuda)
    outs = {}
    for fn in (tmt.scaled_update_kernel, tmt.scaled_update_torch):
        pk = p.clone()
        ck = None if copy is None else p.to(copy, copy=True)
        fn(pk, u, ratio, spec, found_inf=found, copy_out=ck)
        outs[fn] = (pk, ck)
    torch.cuda.synchronize()
    (pk, ck), (pr, _) = outs[tmt.scaled_update_kernel], outs[tmt.scaled_update_torch]
    if skip:
        assert torch.equal(pk, p) and torch.equal(ck, p.to(copy))
        return
    # one ulp where the compiler contracts p - c * u into an fma: an ulp of
    # p or of c * u, which may nearly cancel
    torch.testing.assert_close(pk, pr, rtol=1e-6, atol=1e-6 * float(pr.abs().max()))
    assert torch.all(pk[spec.total:] == 0)  # the padding's ratio is 0
    if copy is not None:
        assert torch.equal(ck, pk.to(copy))


# (world, rank) of AWKWARD's arena (98,304 elements): (3, 0) starts at the
# arena's start; (3, 1) lies wholly inside the 70,000-element tensor; (3, 2)
# starts inside it and its block at 78,208 - 65,536 holds the shard's first
# tensor start; (2, 1) starts inside it and is mostly padding; (4, 3) is all
# padding
SHARDS = [(3, 0), (3, 1), (3, 2), (2, 1), (4, 3)]


@pytest.mark.parametrize("world, rank", SHARDS)
def test_k8_shard_mode_matches_plain_and_the_whole_arena(cuda, world, rank):
    """ZeRO's shard mode: only K8's tables change (built from the shard's
    base), the ratios stay one per tensor of the whole arena (global ids),
    positions past the arena's tensors take the padding's ratio 0."""
    from beforeholiday_tpu_torch.ops.arena import ArenaShard
    from beforeholiday_tpu_torch.optimizers.distributed_fused import _shard_len

    spec = make_spec(AWKWARD)
    shard = _shard_len(spec.padded_total, world)
    g = _gen(18)
    p = torch.randn(shard * world, generator=g, device=cuda)
    p[spec.total:] = 0
    u = torch.randn(shard * world, generator=g, device=cuda)
    ratio = 1e-3 * (0.5 + torch.rand(spec.num_tensors, generator=g, device=cuda))
    seg = ArenaShard(spec, rank, shard)
    lo, hi = rank * shard, (rank + 1) * shard
    outs = {}
    for fn in (tmt.scaled_update_kernel, tmt.scaled_update_torch):
        pk, ck = p[lo:hi].clone(), torch.empty(shard, dtype=torch.bfloat16, device=cuda)
        fn(pk, u[lo:hi], ratio, spec, found_inf=None, copy_out=ck, shard=seg)
        outs[fn] = (pk, ck)
    whole = p[: spec.padded_total].clone()
    tmt.scaled_update_kernel(whole, u[: spec.padded_total].contiguous(), ratio, spec,
                             found_inf=None, copy_out=None)
    torch.cuda.synchronize()
    (pk, ck), (pr, _) = outs[tmt.scaled_update_kernel], outs[tmt.scaled_update_torch]
    torch.testing.assert_close(pk, pr, rtol=1e-6, atol=1e-6 * float(pr.abs().max()))
    assert torch.equal(ck, pk.to(torch.bfloat16))
    # the same launch's elements as the unsharded K8's, bitwise
    n = max(0, min(hi, spec.padded_total) - lo)
    assert torch.equal(pk[:n], whole[lo: lo + n])
    past = max(spec.total - lo, 0)
    assert torch.all(pk[past:] == p[lo:hi][past:])  # the padding did not move


@pytest.mark.parametrize("world, rank", SHARDS[:3])
def test_k6_on_a_shard_matches_plain(cuda, world, rank):
    """K6 on a ZeRO shard (TILE-aligned, no model copy), as ZeRO-2 and
    ZeRO-3 launch it."""
    from beforeholiday_tpu_torch.optimizers.distributed_fused import _shard_len

    shard = _shard_len(make_spec(AWKWARD).padded_total, world)
    g = _gen(19 + rank)
    grad = torch.randn(shard, generator=g, device=cuda)
    p = torch.randn(shard, generator=g, device=cuda)
    m = 0.1 * torch.randn(shard, generator=g, device=cuda)
    v = 0.01 * torch.rand(shard, generator=g, device=cuda)
    step = torch.full((), 2, dtype=torch.int32, device=cuda)
    bc1, bc2 = tmt._bias_corrections(True, step, 0.9, 0.999)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, bc1=bc1, bc2=bc2,
              weight_decay=0.01, adam_w_mode=True, grad_scale=1.0,
              found_inf=torch.zeros((), dtype=torch.bool, device=cuda), copy_out=None)
    outs = {}
    for fn in (tmt.adam_kernel, tmt.adam_torch):
        st = (p.clone(), m.clone(), v.clone())
        fn(grad, *st, **kw)
        outs[fn] = st
    torch.cuda.synchronize()
    # test_k6_matches_plain's tolerance: an ulp where the compiler contracts
    # a multiply-add, of the largest term where m's terms cancel
    for a, b in zip(outs[tmt.adam_kernel], outs[tmt.adam_torch]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_k8_refuses_a_ratio_per_layer(cuda):
    """One ratio per spec tensor, never per layer view."""
    spec = make_spec(AWKWARD)
    p = torch.zeros(spec.padded_total, device=cuda)
    with pytest.raises(ValueError):
        tmt.scaled_update_kernel(p, p, torch.ones(spec.num_tensors + 1, device=cuda),
                                 spec, found_inf=None, copy_out=None)


# ------------------------------------------------- BERT + LAMB step


def test_bert_lamb_step_kernels_match_plain_path(cuda):
    """One O5 arena-native FusedLAMB step of a 2-layer bf16 BERT with
    ragged sequence lengths on K1-K5 and K7-K9 against the same step with
    every op on its plain version."""
    base = dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4,
                n_layers=2, dtype=torch.bfloat16)
    params = bert.init(bert.BertConfig(**base), _gen(0), device=cuda)
    tok, tgt, mask, nsp = bert.synthetic_batch(bert.BertConfig(**base), 2,
                                               generator=_gen(1), device=cuda)
    lens = torch.tensor([128, 77], dtype=torch.int32, device=cuda)
    counters = (tmt.l2norm_sq_kernel, tmt.lamb_stage1_kernel,
                tmt.scaled_update_kernel, tattn.flash_bwd_kernel)
    res = {}
    for impl in ("kernel", "torch"):
        cfg = bert.BertConfig(**base, attention_impl=impl, norm_impl=impl)
        m = amp.initialize(lambda p, t, cfg=cfg: bert.forward(p, t, cfg), params,
                           FusedLAMB(lr=1e-3, weight_decay=0.01, impl=impl),
                           "O5", arena_native=True)
        svag = amp.scaled_value_and_grad(
            lambda p, cfg=cfg: bert.pretrain_loss(p.unpack(), tok, tgt, mask,
                                                  nsp, cfg, seq_lens=lens),
            m.scaler, impl=impl)
        o, s = m.optimizer.init(m.params), m.scaler.init()
        before = [fn.launches for fn in counters]
        loss, g, fi, s = svag(m.params, s)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        torch.cuda.synchronize()
        launched = [fn.launches - b for fn, b in zip(counters, before)]
        assert launched == ([2, 2, 2, 2] if impl == "kernel" else [0, 0, 0, 0])
        res[impl] = (loss, g.arenas, o["master"], m.params.arenas)
    (lk, gk, mk, pk), (lt, gt, mt_, pt) = res["kernel"], res["torch"]
    torch.testing.assert_close(lk, lt, rtol=2e-3, atol=0)
    for a, b in zip(gk, gt):
        torch.testing.assert_close(a, b, rtol=0.05, atol=2e-2 * float(b.abs().max()))
    for a, b in zip(mk, mt_):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-3)  # up to 3 lr
    for arena, master in zip(pk, mk):
        assert torch.equal(arena, master.to(arena.dtype))


# ------------------------------------------------------------------ K10


@pytest.mark.parametrize("n, copy, first, skip, variant", [
    (4 * 32768, torch.bfloat16, False, False, "plain"),
    (4 * 32768, torch.bfloat16, True, False, "plain"),
    (100003, None, False, False, "nesterov"),
    (100003, torch.float32, True, False, "damp_wd_after"),
    (4099, torch.bfloat16, False, False, "no_momentum"),
    (4 * 32768, torch.bfloat16, False, True, "plain"),
])
def test_k10_matches_plain(cuda, n, copy, first, skip, variant, pdt=torch.float32):
    hyper = {"plain": dict(momentum=0.9, dampening=0.0, nesterov=False,
                           wd_after_momentum=False),
             "nesterov": dict(momentum=0.9, dampening=0.0, nesterov=True,
                              wd_after_momentum=False),
             "damp_wd_after": dict(momentum=0.9, dampening=0.1, nesterov=False,
                                   wd_after_momentum=True),
             "no_momentum": dict(momentum=0.0, dampening=0.0, nesterov=False,
                                 wd_after_momentum=False)}[variant]
    g = _gen(10)
    grad = torch.randn(n, generator=g, device=cuda)
    # fp16 or bf16 p: amp O3's list path, fp32 momentum
    p = torch.randn(n, generator=g, device=cuda).to(pdt)
    m = 0.1 * torch.randn(n, generator=g, device=cuda)
    kw = dict(lr=0.05, weight_decay=1e-4, scale=torch.full((), 0.5, device=cuda),
              first_run=torch.full((), first, dtype=torch.bool, device=cuda),
              found_inf=torch.full((), skip, dtype=torch.bool, device=cuda), **hyper)
    outs = {}
    for impl in ("kernel", "torch"):
        pk, mk = p.clone(), m.clone()
        ck = None if copy is None else p.to(copy, copy=True)
        before = tmt.sgd_kernel.launches
        tmt.sgd_flat(grad, pk, mk, model_copy=ck, impl=impl, **kw)
        assert tmt.sgd_kernel.launches - before == (impl == "kernel")
        outs[impl] = (pk, mk, ck)
    torch.cuda.synchronize()
    (pk, mk, ck), (pt, mt_, _) = outs["kernel"], outs["torch"]
    if skip:  # bitwise untouched
        assert torch.equal(pk, p) and torch.equal(mk, m)
        assert copy is None or torch.equal(ck, p.to(copy))
        return
    torch.testing.assert_close(mk, mt_, rtol=1e-6, atol=1e-6 * float(mt_.abs().max()))
    if pdt == torch.float32:
        torch.testing.assert_close(pk, pt, rtol=1e-6, atol=1e-6 * float(pt.abs().max()))
    else:
        # the fp32 rows' bound (one of the fp32 values is contracted into an
        # fma), then one rounding to p's type: one ulp apart where they
        # straddle a boundary; the atol also covers fp16's absolute step of
        # 2^-24 below 2^-14
        ulp = 2 ** -10 if pdt == torch.float16 else 2 ** -7
        torch.testing.assert_close(pk.float(), pt.float(), rtol=ulp,
                                   atol=1e-6 * float(pt.float().abs().max()))
    if copy is not None and pdt == torch.float32:
        assert torch.equal(ck, pk.to(copy))


@pytest.mark.parametrize("pdt", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("n, first, skip, variant", [
    (25_559_040, False, False, "plain"),   # ResNet-50 O3's list path
    (100003, True, False, "nesterov"),
    (4099, False, False, "no_momentum"),
    (4 * 32768, False, True, "plain"),
])
def test_k10_half_params_match_plain(cuda, n, first, skip, variant, pdt):
    """K10 on fp16 or bf16 params with fp32 momentum (amp O3's FusedSGD
    list path): fp32 math, p stored back in its own dtype."""
    test_k10_matches_plain(cuda, n, None, first, skip, variant, pdt)


def test_resnet_step_kernels_match_plain_path(cuda):
    """One O5 arena-native FusedSGD step of a small bottleneck ResNet
    through the ImageNet trainer on K5 and K10 against the same step with
    both on their plain versions; the model arenas are the masters' cast."""
    from beforeholiday_tpu_torch.examples.imagenet import main_amp
    from beforeholiday_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig(block="bottleneck", layers=(1, 1), width=16,
                              num_classes=10)
    weights = resnet.init(cfg, _gen(0), device=cuda)
    g = _gen(1)
    images = torch.randint(0, 256, (8, 32, 32, 3), generator=g, device=cuda,
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (8,), generator=g, device=cuda)
    res = {}
    for impl in ("kernel", "torch"):
        tr = main_amp.build_trainer(cfg=cfg, opt_level="O5", global_batch=8,
                                    params=weights[0], bn_state=weights[1],
                                    impl=None if impl == "kernel" else "torch")
        before = (tmt.scale_kernel.launches, tmt.sgd_kernel.launches)
        met = tr.step(images, labels, 0.05)
        torch.cuda.synchronize()
        launched = [tmt.scale_kernel.launches - before[0],
                    tmt.sgd_kernel.launches - before[1]]
        assert launched == ([2, 2] if impl == "kernel" else [0, 0])
        assert not bool(met["found_inf"])
        for arena, master in zip(tr.params.arenas, tr.opt_state["master"]):
            assert torch.equal(arena, master.to(arena.dtype))
        res[impl] = (met["loss"], tr.opt_state["master"],
                     [b["momentum_buffer"] for b in tr.opt_state["inner"]])
    (lk, mk, bk), (lt, mt_, bt) = res["kernel"], res["torch"]
    torch.testing.assert_close(lk, lt, rtol=1e-5, atol=0)
    # cuDNN may sum the weight gradients in another order from run to run
    for a, b in zip(bk, bt):
        torch.testing.assert_close(a, b, rtol=0.05, atol=2e-2 * float(b.abs().max()))
    for a, b, m in zip(mk, mt_, bt):
        # one step from the same masters: they part by lr times the
        # momentum's difference
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=0.05 * 2e-2 * float(m.abs().max()) + 1e-7)


# ------------------------------------------------------------- K16-K18


@pytest.mark.parametrize("n, dtype, out_dtype, check, poison", [
    (4 * 32768, torch.float32, torch.float32, 0, None),
    (100003, torch.bfloat16, torch.bfloat16, -1, None),
    (100003, torch.bfloat16, torch.float32, 1, None),
    (100003, torch.float32, torch.bfloat16, 0, None),
    (1, torch.float32, torch.float32, -1, None),
    (100003, torch.bfloat16, torch.bfloat16, -1, ("x", float("nan"))),
    (100003, torch.bfloat16, torch.bfloat16, 1, ("x", float("nan"))),
    (100003, torch.float32, torch.float32, 0, ("y", float("inf"))),
    (100003, torch.float32, torch.float32, 1, ("y", float("inf"))),
])
def test_k16_matches_plain(cuda, n, dtype, out_dtype, check, poison):
    """out = a x + b y and the flag of the checked inputs: fp32 outputs to
    one ulp (an fma), half outputs one ulp of theirs; non-finite outputs in
    the same places."""
    g = _gen(16)
    x = torch.randn(n, generator=g, device=cuda).to(dtype)
    y = torch.randn(n, generator=g, device=cuda).to(dtype)
    if poison is not None:
        (x if poison[0] == "x" else y)[n // 3] = poison[1]
    a = torch.full((), 0.75, device=cuda)
    outs = {}
    for impl in ("kernel", "torch"):
        before = tmt.axpby_kernel.launches
        (out,), flag = tmt.multi_tensor_axpby([x], [y], a, -1.5, out_dtype=out_dtype,
                                              arg_to_check=check, impl=impl)
        assert tmt.axpby_kernel.launches - before == (impl == "kernel")
        outs[impl] = (out, flag)
    torch.cuda.synchronize()
    (out, flag), (ref, rflag) = outs["kernel"], outs["torch"]
    expect = poison is not None and check in (-1, "xy".index(poison[0]))
    assert bool(flag) == bool(rflag) == expect
    assert out.dtype == out_dtype and out.shape == (n,)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(out), fin)
    rtol = 1e-6 if out_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out[fin], ref[fin], rtol=rtol,
                               atol=1e-6 * float(ref[fin].abs().max()))


@pytest.mark.parametrize("n, gdt, mode, skip", [
    (4 * 32768, torch.float32, 0, False),
    (4 * 32768, torch.float32, 1, False),
    (100003, torch.bfloat16, 0, False),
    (1, torch.float32, 1, False),
    (4 * 32768, torch.float32, 0, True),
])
def test_k17_matches_plain(cuda, n, gdt, mode, skip):
    g = _gen(17)
    grad = torch.randn(n, generator=g, device=cuda)
    if skip:
        grad[n // 2] = float("inf")
    grad = grad.to(gdt)
    p = torch.randn(n, generator=g, device=cuda)
    h = 0.1 * torch.rand(n, generator=g, device=cuda)
    kw = dict(lr=torch.full((), 0.05, device=cuda), eps=1e-10, weight_decay=1e-2,
              mode=mode, found_inf=torch.full((), skip, dtype=torch.bool, device=cuda))
    outs = {}
    for fn in (tmt.adagrad_kernel, tmt.adagrad_torch):
        pk, hk = p.clone(), h.clone()
        fn(grad, pk, hk, **kw)
        outs[fn] = (pk, hk)
    torch.cuda.synchronize()
    got, ref = outs[tmt.adagrad_kernel], outs[tmt.adagrad_torch]
    if skip:  # bitwise untouched
        assert torch.equal(got[0], p) and torch.equal(got[1], h)
        return
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("gdt, mode, skip", [
    (torch.float32, 0, False), (torch.float32, 1, False),
    (torch.bfloat16, 0, False), (torch.float32, 1, True),
])
def test_k18_matches_plain(cuda, gdt, mode, skip):
    """The per-tensor denominators through the segment table over the
    awkward layout; the padding (the gradient's is 0) stays 0."""
    spec = make_spec(AWKWARD)
    n = spec.padded_total
    g = _gen(18)
    grad = torch.randn(n, generator=g, device=cuda)
    p = torch.randn(n, generator=g, device=cuda)
    m = 0.1 * torch.randn(n, generator=g, device=cuda)
    for t in (grad, p, m):
        t[spec.total:] = 0
    if skip:
        grad[n // 3] = float("inf")
    grad = grad.to(gdt)
    denom = 0.5 + torch.rand(spec.num_tensors, generator=g, device=cuda)
    kw = dict(beta1=0.95, beta3=0.05, bc1=torch.full((), 0.185, device=cuda),
              lr=0.05, weight_decay=1e-2, mode=mode,
              found_inf=torch.full((), skip, dtype=torch.bool, device=cuda))
    outs = {}
    for fn in (tmt.novograd_kernel, tmt.novograd_torch):
        pk, mk = p.clone(), m.clone()
        fn(grad, pk, mk, denom, spec, **kw)
        outs[fn] = (pk, mk)
    torch.cuda.synchronize()
    got, ref = outs[tmt.novograd_kernel], outs[tmt.novograd_torch]
    if skip:
        assert torch.equal(got[0], p) and torch.equal(got[1], m)
        return
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
        assert not a[spec.total:].any()


def test_k18_refuses_a_denominator_per_layer(cuda):
    spec = make_spec(AWKWARD)
    p = torch.zeros(spec.padded_total, device=cuda)
    with pytest.raises(ValueError):
        tmt.novograd_kernel(p, p, p.clone(), torch.ones(spec.num_tensors + 1, device=cuda),
                            spec, beta1=0.95, beta3=0.05, bc1=1.0, lr=0.1,
                            weight_decay=0.0, mode=0, found_inf=None)


# the list-path optimizers of slice 8: options of build_trainer, and the
# kernel each launches once a step (at O5, over the one fp32 master bucket)
LIST_PATHS = {
    "adagrad": (lambda impl: dict(fused_optimizer=FusedAdagrad(weight_decay=1e-4, impl=impl)),
                tmt.adagrad_kernel),
    "novograd": (lambda impl: dict(fused_optimizer=FusedNovoGrad(weight_decay=1e-4, impl=impl)),
                 tmt.novograd_kernel),
    "lars": (lambda impl: dict(fused_optimizer=FusedLARS(0.05, momentum=0.9, weight_decay=1e-4,
                                                         impl=impl)), tmt.sgd_kernel),
    "larc": (lambda impl: dict(use_larc=True, weight_decay=0.0), tmt.sgd_kernel),
}


@pytest.mark.parametrize("name", list(LIST_PATHS))
def test_resnet_list_path_kernels_match_plain_path(cuda, name):
    """One O5 step of a small bottleneck ResNet through the ImageNet trainer
    with FusedAdagrad, FusedNovoGrad, FusedLARS or LARC (the list path) on
    K5 and the optimizer's kernel against the same step on the plain
    versions, cuDNN held to deterministic algorithms so both get the same
    gradients: the loss bitwise, the masters and state to one ulp; the
    model is the masters' cast."""
    from beforeholiday_tpu_torch.examples.imagenet import main_amp
    from beforeholiday_tpu_torch.models import resnet

    options, kernel = LIST_PATHS[name]
    cfg = resnet.ResNetConfig(block="bottleneck", layers=(1, 1), width=16,
                              num_classes=10)
    weights = resnet.init(cfg, _gen(0), device=cuda)
    g = _gen(1)
    images = torch.randint(0, 256, (8, 32, 32, 3), generator=g, device=cuda,
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (8,), generator=g, device=cuda)
    res = {}
    for impl in ("kernel", "torch"):
        plain = None if impl == "kernel" else "torch"
        tr = main_amp.build_trainer(cfg=cfg, opt_level="O5", global_batch=8,
                                    params=weights[0], bn_state=weights[1],
                                    impl=plain, **options(plain))
        before = (tmt.scale_kernel.launches, kernel.launches)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True):
            met = tr.step(images, labels, 0.05)
        torch.cuda.synchronize()
        launched = [tmt.scale_kernel.launches - before[0], kernel.launches - before[1]]
        assert launched == ([2, 1] if impl == "kernel" else [0, 0])
        assert not bool(met["found_inf"]) and int(tr.opt_state["inner"]["step"]) == 1
        masters = tree_flatten(tr.opt_state["master"])[0]
        for p, m in zip(tree_flatten(tr.params)[0], masters):
            assert torch.equal(p, m.to(p.dtype))
        state = [x for k, v in sorted(tr.opt_state["inner"].items()) if k != "step"
                 for x in tree_flatten(v)[0]]
        res[impl] = (met["loss"], masters, state)
    (lk, mk, sk), (lt, mt_, st) = res["kernel"], res["torch"]
    assert torch.equal(lk, lt)
    for a, b in zip(mk + sk, mt_ + st):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


# ------------------------------------------------------------- K11, K12


def _softmax_inputs(B, H, sq, sk, dtype, mask_kind, seed=0):
    """Scores (scaled by 3 so the softmax is not nearly uniform) and the
    mask: None, causal, a (B, 1, 1, sk) key-padding mask from ragged
    lengths (a length-0 row fully masked), or a (B, 1, sq, sk) mask with a
    fully masked row; both expanded to the scores' shape as views."""
    g = _gen(seed)
    x = (3 * torch.randn(B, H, sq, sk, generator=g, device="cuda")).to(dtype)
    if mask_kind in (None, "causal"):
        return x, None
    if mask_kind == "keys":
        lens = torch.tensor(_ragged(B, sk, seed), device="cuda")
        mask = (torch.arange(sk, device="cuda")[None, :] >= lens[:, None])
        mask = mask[:, None, None, :]
    else:
        mask = torch.rand(B, 1, sq, sk, generator=g, device="cuda") > 0.7
        mask[0, 0, 1] = True
    return x, mask.expand(x.shape)


SOFTMAX_CASES = [  # B, H, sq, sk, dtype, mask kind
    (256, 1, 1024, 1024, torch.bfloat16, "causal"),   # GPT-unfused training
    (128, 16, 128, 128, torch.bfloat16, "keys"),      # BERT-unfused training
    (8, 1, 1000, 1000, torch.bfloat16, "causal"),     # sk no power of two
    (16, 1, 96, 96, torch.float32, "causal"),         # sq % 128 != 0
    (4, 2, 33, 77, torch.float32, "full"),
    (4, 2, 33, 77, torch.bfloat16, "full"),
    (2, 1, 4, 16384, torch.float32, "full"),          # the widest row
    (3, 2, 5, 77, torch.float16, None),               # scale only
]


def _softmax_tag(case):
    B, H, sq, sk, dt, kind = case
    return f"{B}x{H}x{sq}x{sk}-{str(dt)[6:]}-{kind}"


# K11's probabilities: relative, since at sk 1024 most lie far below 2^-8;
# half types one rounding apart, fp32 exp and row sums in another order
PROB_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-8),
            torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6),
            torch.float16: dict(rtol=2 ** -9, atol=1e-7)}
# K12's gradients: rtol (one rounding in half types) plus SUM_TOL times
# scale |y| sum|dy y|, which bounds the row sum's error in another order where
# dy - sum cancels; it follows each element, so a wrong row of small
# gradients fails
GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7, torch.float16: 2 ** -9}
SUM_TOL = 1e-5


def _assert_softmax_grad_close(dx, ref, y, dy, scale, rtol):
    y, dy = y.float(), dy.float()
    bound = SUM_TOL * scale * y.abs() * (y * dy).abs().sum(-1, keepdim=True)
    bound += rtol * ref.float().abs()
    bad = (dx.float() - ref.float()).abs() > bound
    assert not bad.any(), (f"{int(bad.sum())} of {bad.numel()} elements out of "
                           f"tolerance, first at {bad.nonzero()[0].tolist()}")


@pytest.mark.parametrize("case", SOFTMAX_CASES, ids=_softmax_tag)
def test_k11_matches_plain(cuda, case):
    B, H, sq, sk, dtype, kind = case
    x, mask = _softmax_inputs(B, H, sq, sk, dtype, kind)
    args = (x, 0.125, kind == "causal", mask)
    before = tsm.softmax_fwd_kernel.launches
    y, y32 = tsm.softmax_fwd_kernel(*args)
    assert tsm.softmax_fwd_kernel.launches == before + 1
    ry, ry32 = tsm.softmax_fwd_torch(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, **PROB_TOL[dtype])
    if mask is None:
        assert y32 is None
        return
    torch.testing.assert_close(y32, ry32, **PROB_TOL[torch.float32])
    assert torch.equal(y, y32.to(dtype))
    # a fully masked row: uniform 1/sk (-10000, not -inf)
    row = y32[0, 0, 0] if kind == "keys" else y32[0, 0, 1]
    torch.testing.assert_close(row, torch.full_like(row, 1 / sk),
                               **PROB_TOL[torch.float32])


@pytest.mark.parametrize("case", SOFTMAX_CASES, ids=_softmax_tag)
def test_k12_matches_plain(cuda, case):
    B, H, sq, sk, dtype, kind = case
    x, mask = _softmax_inputs(B, H, sq, sk, dtype, kind)
    # the backward reads what the forward saved: the fp32 y with a mask,
    # y in x's dtype without one
    y, y32 = tsm.softmax_fwd_torch(x, 0.125, kind == "causal", mask)
    saved = y if mask is None else y32
    dy = torch.randn(x.shape, generator=_gen(1), device="cuda").to(dtype)
    before = tsm.softmax_bwd_kernel.launches
    dx = tsm.softmax_bwd_kernel(saved, dy, 0.125, mask)
    assert tsm.softmax_bwd_kernel.launches == before + 1
    rdx = tsm.softmax_bwd_torch(saved, dy, 0.125, mask)
    torch.cuda.synchronize()
    assert dx.dtype == rdx.dtype == dtype
    _assert_softmax_grad_close(dx, rdx, saved, dy, 0.125, GRAD_RTOL[dtype])
    if mask is not None:
        assert torch.all(dx[mask] == 0)


def test_softmax_public_path_launches(cuda):
    """impl=None on a CUDA tensor launches K11 forward and K12 backward,
    one each, for every public variant."""
    x = torch.randn(2, 4, 64, 64, device=cuda, dtype=torch.bfloat16)
    mask = torch.rand(2, 1, 1, 64, device=cuda) > 0.5
    calls = [lambda a: tsm.scaled_softmax(a, 0.5),
             lambda a: tsm.scaled_masked_softmax(a, mask, 0.5),
             lambda a: tsm.generic_scaled_masked_softmax(a, mask, 0.5),
             lambda a: tsm.scaled_upper_triang_masked_softmax(a[0], 0.5)]
    for fn in calls:
        xa = x.clone().requires_grad_(True)
        before = (tsm.softmax_fwd_kernel.launches, tsm.softmax_bwd_kernel.launches)
        y = fn(xa)
        assert tsm.softmax_fwd_kernel.launches == before[0] + 1
        y.float().sum().backward()
        assert tsm.softmax_bwd_kernel.launches == before[1] + 1
        assert y.dtype == xa.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("what", ["too_wide", "fp64", "strided", "mask_shape"])
def test_k11_refuses_what_it_does_not_take(cuda, what):
    x = torch.zeros(1, 1, 4, 16385 if what == "too_wide" else 64, device=cuda,
                    dtype=torch.float64 if what == "fp64" else torch.float32)
    mask = None
    if what == "strided":
        x = x.transpose(-1, -2)
    if what == "mask_shape":
        mask = torch.zeros(1, 1, 1, 64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        tsm.softmax_fwd_kernel(x, 1.0, False, mask)


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_unfused_step_kernels_match_plain_path(cuda, model):
    """One O5 arena-native step of a small bf16 model with unfused
    attention on K11/K12 (and K1/K3, K5 and the optimizer kernels) against
    the same step with every op on its plain version."""
    base = dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4,
                n_layers=2, dtype=torch.bfloat16, use_flash_attention=False)
    mod, opt = (gpt, lambda impl: FusedAdam(lr=1e-3, impl=impl)) if model == "gpt" \
        else (bert, lambda impl: FusedLAMB(lr=1e-3, weight_decay=0.01, impl=impl))
    cfg0 = (gpt.GPTConfig if model == "gpt" else bert.BertConfig)(**base)
    params = mod.init(cfg0, _gen(0), device=cuda)
    if model == "gpt":
        batch = gpt.synthetic_batch(cfg0, 2, generator=_gen(1), device=cuda)
    else:
        batch = (*bert.synthetic_batch(cfg0, 2, generator=_gen(1), device=cuda),
                 torch.tensor([128, 77], dtype=torch.int32, device=cuda))
    res = {}
    for impl in ("kernel", "torch"):
        cfg = dataclasses.replace(cfg0, attention_impl=impl, norm_impl=impl)
        m = amp.initialize(lambda p, t, cfg=cfg: mod.forward(p, t, cfg), params,
                           opt(impl), "O5", arena_native=True)
        if model == "gpt":
            loss_fn = (lambda p, a, b, cfg=cfg, m=m:
                       gpt.loss_fn(p, a, b, cfg, forward_fn=m.apply))
        else:
            loss_fn = (lambda p, tok, tgt, mask, nsp, lens, cfg=cfg:
                       bert.pretrain_loss(p.unpack(), tok, tgt, mask, nsp, cfg,
                                          seq_lens=lens))
        svag = amp.scaled_value_and_grad(loss_fn, m.scaler, impl=impl)
        o, s = m.optimizer.init(m.params), m.scaler.init()
        counters = (tsm.softmax_fwd_kernel, tsm.softmax_bwd_kernel,
                    tattn.flash_fwd_kernel, tattn.flash_bwd_kernel)
        counts = [fn.launches for fn in counters]
        loss, g, fi, s = svag(m.params, s, *batch)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        torch.cuda.synchronize()
        launched = [fn.launches - c for fn, c in zip(counters, counts)]
        assert launched == ([2, 2, 0, 0] if impl == "kernel" else [0, 0, 0, 0])
        res[impl] = (loss, g.arenas, o["master"], m.params.arenas)
    (lk, gk, mk, pk), (lt, gt, mt_, pt) = res["kernel"], res["torch"]
    torch.testing.assert_close(lk, lt, rtol=2e-3, atol=0)
    for a, b in zip(gk, gt):
        torch.testing.assert_close(a, b, rtol=0.05, atol=2e-2 * float(b.abs().max()))
    for a, b in zip(mk, mt_):
        torch.testing.assert_close(a, b, rtol=0, atol=3.5e-3)  # up to 3 lr
    for arena, master in zip(pk, mk):
        assert torch.equal(arena, master.to(arena.dtype))


# ------------------------------------------------------------ dropout (K13)


def _key(seed):
    from beforeholiday_tpu_torch.transformer.tensor_parallel.random import make_key

    return make_key(seed, device="cuda")


@pytest.mark.parametrize("shape, rate", [
    ((256, 1024, 1024), 0.1), ((1, 16384, 1024), 0.3), ((3, 7, 13), 0.5),
    ((16, 1024, 1024), 0.1), ((2, 5, 9), 0.0), ((70000, 3, 5), 0.2),
    ((2048, 128, 128), 0.1), ((5, 33, 70), 0.999999999),
])
def test_k13_matches_its_twin_bitwise(cuda, shape, rate):
    key = _key(sum(shape))
    before = tattn.dropout_keep_mask_kernel.launches
    mask = tattn.dropout_keep_mask(key, shape, rate)
    assert tattn.dropout_keep_mask_kernel.launches == before + 1
    ref = tattn.dropout_keep_mask_torch(key, shape, rate)
    torch.cuda.synchronize()
    assert mask.dtype == torch.bool and torch.equal(mask, ref)
    n, p = mask.numel(), 1.0 - rate
    assert abs(float(mask.sum()) - n * p) <= 6 * (n * p * (1 - p)) ** 0.5 + 1e-9


# (BH, Sq, Sk, D, causal, dtype): the tensor-core, decode and CUDA-core
# kernels, and head dims only the row kernels take
DROPOUT_SHAPES = [
    (64, 1024, 1024, 64, True, torch.bfloat16),
    (256, 128, 128, 64, False, torch.bfloat16),
    (16, 5, 70, 64, False, torch.bfloat16),
    (8, 100, 100, 80, True, torch.float32),
    (4, 100, 100, 8, True, torch.bfloat16),
    (4, 100, 100, 40, False, torch.float32),
    (4, 100, 100, 256, True, torch.bfloat16),
    (4, 70, 90, 512, False, torch.float32),
    (4, 64, 64, 512, True, torch.bfloat16),
]


@pytest.mark.parametrize("BH, Sq, Sk, D, causal, dtype", DROPOUT_SHAPES)
def test_k2_k4_with_dropout_match_plain(cuda, BH, Sq, Sk, D, causal, dtype):
    q, k, v, lens = _k2_inputs(BH, Sq, Sk, D, dtype, _ragged(BH, Sk), seed=5)
    scale, key, rate = D ** -0.5, _key(D), 0.1
    o, lse = tattn.flash_fwd_kernel(q, k, v, lens, causal, scale, rate, key)
    ro, rlse = tattn.flash_fwd_torch(q, k, v, lens, causal, scale, rate, key)
    do = torch.randn(o.shape, generator=_gen(6), device=cuda).to(dtype)
    got = tattn.flash_bwd_kernel(q, k, v, ro, do, rlse, None, lens, causal, scale,
                                 rate, key)
    ref = tattn.flash_bwd_torch(q, k, v, ro, do, rlse, None, lens, causal, scale,
                                rate, key)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        # each kept p / (1 - rate) rounds to bf16 for its product with v:
        # within 2^-8 of sum p |v| where the terms cancel (chip_smoke.py
        # check_dropped_pv, PERF.md)
        ref_abs = tattn.flash_fwd_torch(q.float(), k.float(), v.float().abs(), lens,
                                        causal, scale, rate, key)[0]
        assert bool(((o.float() - ro.float()).abs()
                     <= 2 ** -7 * ro.float().abs() + 2 ** -8 * ref_abs).all())
    else:
        torch.testing.assert_close(o, ro, **FP32_TOL)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, **_k4_tol(dtype, b), msg=name)
    assert all(torch.all(t[0] == 0) for t in got)  # lens 0


def test_k2_k4_and_k13_drop_the_same_slots(cuda):
    """v = I makes o the dropped probabilities (o[b, i, j] = z[b, i, j]) and
    do = I makes dv their transpose: both are 0 exactly where K13 drops."""
    BH, S = 8, 64
    g = _gen(7)
    q, k = (torch.randn(BH, S, S, generator=g, device=cuda) for _ in range(2))
    eye = torch.eye(S, device=cuda).expand(BH, S, S).contiguous()
    lens = torch.full((BH,), S, dtype=torch.int32, device=cuda)
    key = _key(3)
    o, lse = tattn.flash_fwd_kernel(q, k, eye, lens, False, 0.125, 0.3, key)
    _, _, dv = tattn.flash_bwd_kernel(q, k, eye, o, eye, lse, None, lens, False,
                                      0.125, 0.3, key)
    drop = ~tattn.dropout_keep_mask(key, (BH, S, S), 0.3)
    torch.cuda.synchronize()
    assert torch.equal(o == 0, drop)
    assert torch.equal(dv.transpose(1, 2) == 0, drop)


def test_flash_dropout_laws_on_the_card(cuda):
    """Rate 0 is the no-dropout kernel bitwise, the same key repeats and
    another differs, the mean of v = 1 stays 1, and a long causal sequence
    stays finite forward and backward."""
    q, k, v, lens = _k2_inputs(8, 256, 256, 64, torch.bfloat16, [256] * 8)
    o0, _ = tattn.flash_fwd_kernel(q, k, v, lens, False, 0.125)
    assert torch.equal(o0, tattn.flash_fwd_kernel(q, k, v, lens, False, 0.125,
                                                  0.0, _key(1))[0])
    a, _ = tattn.flash_fwd_kernel(q, k, v, lens, False, 0.125, 0.25, _key(1))
    assert torch.equal(a, tattn.flash_fwd_kernel(q, k, v, lens, False, 0.125,
                                                 0.25, _key(1))[0])
    assert not torch.equal(a, tattn.flash_fwd_kernel(q, k, v, lens, False, 0.125,
                                                     0.25, _key(2))[0])
    ones, _ = tattn.flash_fwd_kernel(q, k, torch.ones_like(v), lens, False, 0.125,
                                     0.25, _key(3))
    assert abs(float(ones.float().mean()) - 1.0) < 0.02
    g = _gen(8)
    ql, kl, vl = (torch.randn(1, 8, 8192, 64, generator=g, device=cuda)
                  .bfloat16().requires_grad_(True) for _ in range(3))
    out = tattn.flash_attention(ql, kl, vl, causal=True, dropout_rate=0.1,
                                dropout_key=_key(4))
    out.float().sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(ql.grad).all()


# ------------------------------------------- K2/K4 tensor-core tiles (bf16)


def _k2_k4_against_plain(BH, Sq, Sk, D, causal, dlse, rate, lens, seed):
    """K2 and K4 on their tensor-core paths against the plain versions, K4
    twice bitwise, and exact zeros for a sequence of length 0. K2's output is
    held to check_dropped_pv's bound at every rate: the kernel rounds each p
    to bf16 for its product with v, with or without dropout, and where the
    terms cancel that parts from the fp32 sum by up to 2^-9 sum p|v|, which
    BF16_TOL does not follow (on some seeds one element of the BERT shape's
    16.7M misses it; PERF.md). K4 at _k4_tol."""
    q, k, v, lens = _k2_inputs(BH, Sq, Sk, D, torch.bfloat16, lens, seed=seed)
    scale, key = D ** -0.5, (_key(seed) if rate else None)
    o, lse = tattn.flash_fwd_kernel(q, k, v, lens, causal, scale, rate, key)
    ro, rlse = tattn.flash_fwd_torch(q, k, v, lens, causal, scale, rate, key)
    g = _gen(seed + 1)
    do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
    dl = torch.randn(lse.shape, generator=g, device="cuda") if dlse else None
    args = (q, k, v, ro, do, rlse, dl, lens, causal, scale, rate, key)
    got = tattn.flash_bwd_kernel(*args)
    again = tattn.flash_bwd_kernel(*args)
    ref = tattn.flash_bwd_torch(*args)
    ref_abs = tattn.flash_fwd_torch(q.float(), k.float(), v.float().abs(), lens,
                                    causal, scale, rate, key)[0]
    torch.cuda.synchronize()
    assert bool(((o.float() - ro.float()).abs()
                 <= 2 ** -7 * ro.float().abs() + 2 ** -8 * ref_abs).all())
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, again):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, **_k4_tol(torch.bfloat16, b), msg=name)
        assert torch.equal(a, c), f"{name}: two calls differ"
    if int(lens[0]) == 0:
        assert torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)
        assert all(torch.all(t[0] == 0) for t in got)


@pytest.mark.parametrize("D", range(16, 129, 16))
@pytest.mark.parametrize("causal", [True, False])
def test_k2_k4_tensor_core_head_dims(cuda, D, causal):
    """Every head dim the tensor-core kernels take, ragged lengths, dlse on
    the causal cases and off the others."""
    _k2_k4_against_plain(4, 200, 200, D, causal, causal, 0.0, _ragged(4, 200, D), D)


@pytest.mark.parametrize("Sq, Sk, causal", [
    (17, 17, True), (70, 70, True), (129, 129, True), (200, 200, True),
    (1000, 1000, True), (70, 200, False), (129, 70, False), (200, 1000, False),
    (1000, 1000, False),
])
@pytest.mark.parametrize("dlse", [False, True])
def test_k2_k4_off_the_tiles(cuda, Sq, Sk, causal, dlse):
    """Lengths off the 128-row, 64-key and 32-row tiles, lengths that end
    mid-tile, Sq != Sk without causal, dlse given or absent; D 64 and 128,
    the second with dropout."""
    lens = _ragged(6, Sk, Sq + Sk)
    _k2_k4_against_plain(6, Sq, Sk, 64, causal, dlse, 0.0, lens, Sq)
    _k2_k4_against_plain(6, Sq, Sk, 128, causal, dlse, 0.1, lens, Sk + 1)


@pytest.mark.parametrize("BH, S, causal, full", [
    (256, 1024, True, True),    # the GPT training shape
    (2048, 128, False, False),  # BERT-Large, key padding
])
def test_k2_k4_dropout_at_the_training_shapes(cuda, BH, S, causal, full):
    lens = [S] * BH if full else _ragged(BH, S, 11)
    _k2_k4_against_plain(BH, S, S, 64, causal, False, 0.1, lens, 12)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k4_is_bitwise_deterministic(cuda, rate):
    """No atomics: two K4 calls at the GPT shape give the same bits."""
    q, k, v, lens = _k2_inputs(64, 1024, 1024, 64, torch.bfloat16, [1024] * 64, seed=13)
    key = _key(13) if rate else None
    o, lse = tattn.flash_fwd_kernel(q, k, v, lens, True, 0.125, rate, key)
    do = torch.randn(o.shape, generator=_gen(14), device=cuda).bfloat16()
    args = (q, k, v, o, do, lse, None, lens, True, 0.125, rate, key)
    a, b = tattn.flash_bwd_kernel(*args), tattn.flash_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("S", [64, 128])
def test_tensor_core_k2_k4_and_k13_drop_the_same_slots(cuda, S):
    """As test_k2_k4_and_k13_drop_the_same_slots, in bf16 on the tensor-core
    kernels (head dim S): o = z through v = I, dv = z^T through do = I."""
    BH = 8
    g = _gen(15)
    q, k = (torch.randn(BH, S, S, generator=g, device=cuda).bfloat16() for _ in range(2))
    eye = torch.eye(S, device=cuda).bfloat16().expand(BH, S, S).contiguous()
    lens = torch.full((BH,), S, dtype=torch.int32, device=cuda)
    key = _key(S)
    o, lse = tattn.flash_fwd_kernel(q, k, eye, lens, False, 0.125, 0.3, key)
    _, _, dv = tattn.flash_bwd_kernel(q, k, eye, o, eye, lse, None, lens, False,
                                      0.125, 0.3, key)
    drop = ~tattn.dropout_keep_mask(key, (BH, S, S), 0.3)
    torch.cuda.synchronize()
    assert torch.equal(o == 0, drop)
    assert torch.equal(dv.transpose(1, 2) == 0, drop)


def test_dense_bf16_rounds_once_on_the_card(cuda):
    """fused_dense's bf16 output: cuBLAS's fp32 product plus the fp32 bias
    rounded once, within one bf16 ulp of the exact sum rounded once."""
    from beforeholiday_tpu_torch.ops import fused_dense

    g = _gen(9)
    x = torch.randn(512, 1024, generator=g, device=cuda).bfloat16()
    w = (torch.randn(1024, 1024, generator=g, device=cuda) * 0.03).bfloat16()
    b = torch.randn(1024, generator=g, device=cuda).bfloat16()
    y = fused_dense(x, w, b).float()
    exact = (x.double() @ w.double() + b.double()).to(torch.bfloat16).float()
    # one bf16 ulp, plus the fp32 sums' rounding where the bias cancels the
    # product (as tests/test_torch_dropout.py holds the CPU path)
    bound = (torch.maximum(y.abs(), exact.abs()) * 2.0 ** -7
             + 2.0 ** -20 * (x.float().abs() @ w.float().abs()))
    assert bool(((y - exact).abs() <= bound).all())
    xg = x.clone().requires_grad_(True)
    fused_dense(xg, w, b).float().sum().backward()
    assert xg.grad.dtype == torch.bfloat16 and torch.isfinite(xg.grad.float()).all()


@pytest.mark.parametrize("model, flash", [("gpt", True), ("gpt", False),
                                          ("bert", True), ("bert", False)])
def test_dropout_step_kernels_match_plain_path(cuda, model, flash):
    """One O5 step of a small bf16 model at dropout 0.1/0.1 with one key, on
    K2/K4 (or K11/K12) with in-kernel dropout and K13's masks, against the
    same step on the plain path drawing the twin's masks."""
    from beforeholiday_tpu_torch.transformer.tensor_parallel.random import fold_in

    base = dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4, n_layers=2,
                dtype=torch.bfloat16, use_flash_attention=flash,
                dropout_rate=0.1, attention_dropout=0.1)
    mod, opt = (gpt, lambda impl: FusedAdam(lr=1e-3, impl=impl)) if model == "gpt" \
        else (bert, lambda impl: FusedLAMB(lr=1e-3, weight_decay=0.01, impl=impl))
    cfg0 = (gpt.GPTConfig if model == "gpt" else bert.BertConfig)(**base)
    params = mod.init(cfg0, _gen(0), device=cuda)
    if model == "gpt":
        batch = gpt.synthetic_batch(cfg0, 2, generator=_gen(1), device=cuda)
    else:
        batch = (*bert.synthetic_batch(cfg0, 2, generator=_gen(1), device=cuda),
                 torch.tensor([128, 77], dtype=torch.int32, device=cuda))
    base_key = _key(5)
    res = {}
    for impl in ("kernel", "torch"):
        cfg = dataclasses.replace(cfg0, attention_impl=impl, norm_impl=impl,
                                  dropout_impl=impl)
        apply_fn = (lambda p, t, key, cfg=cfg: gpt.forward(p, t, cfg, dropout_key=key)) \
            if model == "gpt" else (lambda p, t, cfg=cfg: bert.forward(p, t, cfg))
        m = amp.initialize(apply_fn, params, opt(impl), "O5", arena_native=True)
        o, s = m.optimizer.init(m.params), m.scaler.init()
        key = fold_in(base_key, o["inner"][0]["step"])
        if model == "gpt":
            loss_fn = (lambda p, a, b, cfg=cfg, m=m: gpt.loss_fn(
                p, a, b, cfg, forward_fn=lambda pp, t: m.apply(pp, t, key)))
        else:
            loss_fn = (lambda p, tok, tgt, mask, nsp, lens, cfg=cfg:
                       bert.pretrain_loss(p.unpack(), tok, tgt, mask, nsp, cfg,
                                          seq_lens=lens, dropout_key=key))
        svag = amp.scaled_value_and_grad(loss_fn, m.scaler, impl=impl)
        counters = (tattn.dropout_keep_mask_kernel, tattn.flash_fwd_kernel,
                    tattn.flash_bwd_kernel, tsm.softmax_fwd_kernel)
        counts = [fn.launches for fn in counters]
        loss, g, fi, s = svag(m.params, s, *batch)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        torch.cuda.synchronize()
        launched = [fn.launches - c for fn, c in zip(counters, counts)]
        # K13: the embedding site and two hidden sites a layer, plus the
        # probabilities of each layer on the unfused path
        want = [5 + (0 if flash else 2), 2 if flash else 0, 2 if flash else 0,
                0 if flash else 2]
        assert launched == (want if impl == "kernel" else [0, 0, 0, 0])
        res[impl] = (loss, g.arenas, o["master"], m.params.arenas)
    (lk, gk, mk, pk), (lt, gt, mt_, pt) = res["kernel"], res["torch"]
    torch.testing.assert_close(lk, lt, rtol=2e-3, atol=0)
    for a, b in zip(gk, gt):
        torch.testing.assert_close(a, b, rtol=0.05, atol=2e-2 * float(b.abs().max()))
    for a, b in zip(mk, mt_):
        torch.testing.assert_close(a, b, rtol=0, atol=3.5e-3)  # up to 3 lr
    for arena, master in zip(pk, mk):
        assert torch.equal(arena, master.to(arena.dtype))


# --------------------------------------------------------------- K14/K15
#
# loss and lse: |d| <= 1e-5 (|ref| + |lse|), since lse - x[label] cancels for
# rows that are confidently right; dx: |d| <= rtol |ref| + 1e-6 |dy| (p + s/V),
# rtol 1e-5 in fp32 and one rounding in half types (plus fp16's subnormal
# step), since p - s/V cancels
XENT_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7, torch.float16: 2 ** -9}
XENT_ATOL = {torch.float32: 0.0, torch.bfloat16: 0.0, torch.float16: 2 ** -24}


def _xent_inputs(N, V, dtype, pad, seed=0):
    g = _gen(seed)
    x = (2 * torch.randn(N, V, generator=g, device="cuda")).to(dtype)
    lab = torch.randint(0, V, (N,), generator=g, device="cuda")
    lab[:pad] = 0
    return x, lab


def _assert_xent_close(loss, lse, dx, ref, x, dy, s):
    rloss, rlse, rdx = ref
    assert bool(((loss - rloss).abs() <= 1e-5 * (rloss.abs() + rlse.abs())).all())
    assert bool(((lse - rlse).abs() <= 1e-5 * rlse.abs()).all())
    p = torch.exp(x.float() - rlse[:, None])
    bound = (XENT_RTOL[x.dtype] * rdx.float().abs() + XENT_ATOL[x.dtype]
             + 1e-6 * dy.abs()[:, None] * (p + s / x.shape[1]))
    assert bool(((dx.float() - rdx.float()).abs() <= bound).all())


@pytest.mark.parametrize("N, V, dtype, s", [
    (11, 96, torch.float16, 0.1),          # JAX's ragged-rows shape
    (64, 50257, torch.bfloat16, 0.1),      # a tail of 1105 columns in bf16
    (300, 30522, torch.float32, 0.0),      # BERT's vocabulary
    (128, 32000, torch.float32, 0.1),      # the flagship's
    (128, 32000, torch.bfloat16, 0.2),
])
def test_k14_k15_match_plain(cuda, N, V, dtype, s):
    x, lab = _xent_inputs(N, V, dtype, pad=3)
    dy = torch.randn(N, generator=_gen(1), device=cuda)
    dy[:3] = 0  # what the wrapper hands K15 for padded rows
    before = (txent.xent_fwd_kernel.launches, txent.xent_bwd_kernel.launches)
    loss, lse = txent.xent_fwd_kernel(x, lab, s)
    dx = txent.xent_bwd_kernel(x, lab, lse, dy, s)
    assert (txent.xent_fwd_kernel.launches, txent.xent_bwd_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    rloss, rlse = txent.xent_fwd_torch(x, lab, s)
    rdx = txent.xent_bwd_torch(x, lab, lse, dy, s)
    torch.cuda.synchronize()
    assert loss.dtype == lse.dtype == torch.float32 and dx.dtype == dtype
    _assert_xent_close(loss, lse, dx, (rloss, rlse, rdx), x, dy, s)
    assert bool((dx[:3] == 0).all())


@pytest.mark.parametrize("dtype, half_to_float", [
    (torch.float32, False), (torch.bfloat16, True), (torch.bfloat16, False)])
def test_xent_autograd_on_the_card(cuda, dtype, half_to_float):
    """The public function on CUDA tensors launches K14 and K15 once each,
    matches the plain path on the card, and gives the padded rows loss 0
    and gradient 0 exactly."""
    x, lab = _xent_inputs(96, 32000, dtype, pad=32, seed=2)
    w = torch.randn(96, generator=_gen(3), device=cuda)
    out = {}
    for impl in ("kernel", "torch"):
        xl = x.clone().requires_grad_(True)
        before = (txent.xent_fwd_kernel.launches, txent.xent_bwd_kernel.launches)
        loss = softmax_cross_entropy_loss(xl, lab.int(), smoothing=0.1,
                                          half_to_float=half_to_float,
                                          impl=None if impl == "kernel" else impl)
        (loss.float() * w).sum().backward()
        torch.cuda.synchronize()
        launched = (txent.xent_fwd_kernel.launches - before[0],
                    txent.xent_bwd_kernel.launches - before[1])
        assert launched == ((1, 1) if impl == "kernel" else (0, 0))
        assert loss.dtype == (torch.float32 if half_to_float else dtype)
        assert bool((loss[:32] == 0).all()) and bool((xl.grad[:32] == 0).all())
        out[impl] = (loss.float(), xl.grad)
    (lk, gk), (lt, gt) = out["kernel"], out["torch"]
    tol = XENT_RTOL[torch.float32 if half_to_float else dtype]
    torch.testing.assert_close(lk, lt, rtol=tol, atol=1e-5)
    torch.testing.assert_close(gk.float(), gt.float(), rtol=XENT_RTOL[dtype],
                               atol=1e-6 * float(gt.float().abs().max()))


@pytest.mark.parametrize("what", ["float64", "labels_float", "strided", "cpu_labels"])
def test_k14_refuses_what_it_does_not_take(cuda, what):
    x, lab = _xent_inputs(8, 100, torch.float32, pad=0)
    if what == "float64":
        x = x.double()
    elif what == "labels_float":
        lab = lab.float()
    elif what == "strided":
        x = x[:, ::2]
    else:
        lab = lab.cpu()
    with pytest.raises(ValueError, match="K14"):
        txent.xent_fwd_kernel(x, lab, 0.1)


def test_gpt_xent_step_kernels_match_plain_path(cuda):
    """One O5 step of a small bf16 GPT whose loss is the fused cross entropy
    (smoothing 0.1, padding index 0, the first 32 targets padded), on K14
    and K15, against the same step on the plain path."""
    cfg0 = gpt.GPTConfig(vocab_size=512, seq_len=128, d_model=128, n_heads=4,
                         n_layers=2, dtype=torch.bfloat16)
    params = gpt.init(cfg0, _gen(0), device=cuda)
    tok, tgt = gpt.synthetic_batch(cfg0, 2, generator=_gen(1), device=cuda)
    tgt = tgt.clone()
    tgt.view(-1)[:32] = 0
    res = {}
    for impl in ("kernel", "torch"):
        cfg = dataclasses.replace(cfg0, attention_impl=impl, norm_impl=impl)
        m = amp.initialize(lambda p, t, cfg=cfg: gpt.forward(p, t, cfg), params,
                           FusedAdam(lr=1e-3, impl=impl), "O5", arena_native=True)

        def loss_fn(p, a, b, m=m, impl=impl):
            logits = m.apply(p, a)
            per = softmax_cross_entropy_loss(
                logits.reshape(-1, logits.shape[-1]), b.reshape(-1),
                smoothing=0.1, padding_idx=0, impl=None if impl == "kernel" else impl)
            return per.sum() / torch.clamp((b != 0).sum(), min=1)

        svag = amp.scaled_value_and_grad(loss_fn, m.scaler, impl=impl)
        o, s = m.optimizer.init(m.params), m.scaler.init()
        before = (txent.xent_fwd_kernel.launches, txent.xent_bwd_kernel.launches)
        loss, g, fi, s = svag(m.params, s, tok, tgt)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        torch.cuda.synchronize()
        launched = (txent.xent_fwd_kernel.launches - before[0],
                    txent.xent_bwd_kernel.launches - before[1])
        assert launched == ((1, 1) if impl == "kernel" else (0, 0))
        res[impl] = (loss, g.arenas, o["master"])
    (lk, gk, mk), (lt, gt, mt_) = res["kernel"], res["torch"]
    torch.testing.assert_close(lk, lt, rtol=2e-3, atol=0)
    for a, b in zip(gk, gt):
        torch.testing.assert_close(a, b, rtol=0.05, atol=2e-2 * float(b.abs().max()))
    for a, b in zip(mk, mt_):
        torch.testing.assert_close(a, b, rtol=0, atol=2.5e-3)  # up to 2 lr


# ------------------------------------------------- amp O6: the fp8 tier

# the card's fp8 product against its plain version (the same fp8 values
# widened, fp32 torch.matmul), per element: (2·K·2^-24 + 2^-11)·Σ|â||b̂|
# times the output scale. The first term is two fp32 sums of K terms in two
# orders; the second is the fp8 tensor cores' own accumulation, which aligns
# each k-group's products to a narrow window before cuBLAS adds it into
# fp32, a cost that does not shrink with K (chip_smoke.py's o6_gemm lines at
# K 17 and 40, PERF.md)
FP8_SUM_C, FP8_MMA_REL = 2.0, 2.0 ** -11


def fp8_product_bound(qa, qb, inv):
    s = (qa.float().abs() @ qb.float().abs()) * inv.abs()
    return (FP8_SUM_C * qa.shape[1] * 2.0 ** -24 + FP8_MMA_REL) * s


@pytest.mark.parametrize("M, K, N", [(4096, 1024, 3072), (2048, 4096, 1024),
                                     (1000, 40, 24), (33, 17, 9)])
def test_fp8_products_match_plain(cuda, M, K, N):
    """The three products of ``quantized_matmul`` (e4m3 x e4m3, e5m2 x e4m3,
    e4m3 x e5m2), ragged shapes padded, on ``torch._scaled_mm`` against the
    plain product within ``fp8_product_bound``."""
    from beforeholiday_tpu_torch.ops import quantized as tq

    g = _gen(60)
    x = torch.randn(M, K, device=cuda, generator=g).bfloat16()
    w = (torch.randn(K, N, device=cuda, generator=g) * 0.02).bfloat16()
    dy = torch.randn(M, N, device=cuda, generator=g).bfloat16().float()
    sx = tq._jit_scale(tq._amax(x), tq.E4M3_MAX)
    sw = tq._jit_scale(tq._amax(w), tq.E4M3_MAX)
    sg = tq._jit_scale(tq._amax(dy), tq.E5M2_MAX)
    qx, qw, qdy = tq._q_e4m3(x, sx), tq._q_e4m3(w, sw), tq._q_e5m2(dy, sg)
    fp8 = tq.product_counts["fp8_forward"]
    for a, b, inv in ((qx, qw, tq.div(1.0, sx * sw)), (qdy, qw.t(), tq.div(1.0, sg * sw)),
                      (qx.t(), qdy, tq.div(1.0, sx * sg))):
        got = tq._fp8_mm(a, b, inv, "forward")
        ref = tq._plain_mm(a, b, inv, "forward")
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert ((got - ref).abs() <= fp8_product_bound(a, b, inv)).all()
    assert tq.product_counts["fp8_forward"] - fp8 == 3


def test_fp8_casts_match_the_cpu(cuda):
    """The saturating e4m3 and non-saturating e5m2 casts on the card, bit for
    bit the CPU's (which equal JAX's, ``tests/test_torch_quantized.py``),
    over every finite bf16 value times scales that reach ties, subnormals,
    the largest values and overflow."""
    from beforeholiday_tpu_torch.ops import quantized as tq

    x = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(torch.float32)
    x = x[torch.isfinite(x)]
    for s in (1.0, 448.0 / 3.7, 57344.0 / 1.3, 2.0 ** -9, 3.0e4, 1.0e30):
        st = torch.tensor(s)
        for cast in (tq._q_e4m3, tq._q_e5m2):
            assert torch.equal(cast(x, st).view(torch.uint8),
                               cast(x.to(cuda), st.to(cuda)).view(torch.uint8).cpu())


def test_quantized_matmul_on_the_card(cuda):
    """The op on CUDA tensors: fp8 products only (impl None), its result
    within ``quantized_matmul_error_bound`` of the fp32 product, gradients in
    the primal dtypes and within the product bound of the plain products
    (``impl="torch"``) from the same quantized operands."""
    from beforeholiday_tpu_torch.ops import quantized as tq

    g = _gen(61)
    x0 = torch.randn(2, 384, 1024, device=cuda, generator=g).bfloat16()
    w0 = (torch.randn(1024, 1000, device=cuda, generator=g) * 0.02).bfloat16()
    dy = torch.randn(2, 384, 1000, device=cuda, generator=g)
    out = {}
    for impl in (None, "torch"):
        for k in tq.product_counts:
            tq.product_counts[k] = 0
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = tq.quantized_matmul(x, w, impl=impl)
        y.backward(dy)
        path = "fp8" if impl is None else "plain"
        assert tq.product_counts == {**{k: 0 for k in tq.product_counts},
                                     f"{path}_forward": 1, f"{path}_backward": 2}
        assert x.grad.dtype == w.grad.dtype == torch.bfloat16
        out[path] = (y.detach(), x.grad.float(), w.grad.float())
    err = (out["fp8"][0] - x0.float() @ w0.float()).abs().max()
    assert float(err) <= float(tq.quantized_matmul_error_bound(x0, w0))
    for a, b in zip(out["fp8"], out["plain"]):
        rel = float((a - b).norm() / b.norm())
        assert rel < 1e-3, rel


def test_e4m3_engine_kernels_match_plain_path(cuda):
    """An e4m3-page engine on K1/K2 against the same weights on the plain
    path: each decode call runs K2's contiguous decode (once a layer) on the
    gathered, dequantized fp32 pages and never its paged mode; logits within
    the engine's bf16 tolerance; page bytes under half the fp32 layout's."""
    cfg = gpt.GPTConfig(vocab_size=512, seq_len=128, d_model=128, n_heads=4,
                        n_layers=2, dtype=torch.bfloat16)
    params = gpt.init(cfg, _gen(62), device=cuda)
    ecfg = EngineConfig(max_seq_len=128, page_size=16, num_pages=33,
                        batch_buckets=(2, 4), prefill_seq_buckets=(32, 64, 128),
                        weights_dtype="bfloat16", cache_dtype="e4m3")
    engines = {impl: InferenceEngine(params, cfg, ecfg, impl=impl)
               for impl in ("kernel", "torch")}
    assert engines["kernel"]._cache.k.dtype == torch.float8_e4m3fn
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (40, 7, 100)]
    alloc = PageAllocator(ecfg.num_pages)
    tables = [alloc.alloc(pages_for(len(p) + 20, 16)) for p in prompts]
    first = {i: e.prefill(prompts, tables) for i, e in engines.items()}
    toks, lens = first["kernel"].tolist(), [len(p) for p in prompts]
    for _ in range(20):  # across a page boundary for every prompt
        paged, flash = tattn._paged_decode_kernel.launches, tattn.flash_fwd_kernel.launches
        logits = {i: e.decode_logits(toks, lens, tables) for i, e in engines.items()}
        assert tattn.flash_fwd_kernel.launches - flash == cfg.n_layers
        assert tattn._paged_decode_kernel.launches == paged
        assert np.isfinite(logits["kernel"]).all()
        np.testing.assert_allclose(logits["kernel"], logits["torch"], atol=2e-2, rtol=0)
        toks = logits["kernel"].argmax(-1).tolist()
        lens = [n + 1 for n in lens]
    lay = engines["kernel"].layout
    assert lay.page_bytes * 2 < dataclasses.replace(lay, dtype_name="float32").page_bytes


def test_o6_step_kernels_match_plain_path(cuda, monkeypatch):
    """One O6 arena-native step of a 2-layer bf16 GPT on K1-K6 and the fp8
    GEMMs against the same step with every op on its plain version (the
    products widened to fp32). From an empty amax history the weights
    quantize at scale 1, coarsely, so an input one rounding apart can move
    an fp8 value by a whole step: the gradients compare in relative L2, at
    the bound of the CPU test against JAX (``tests/test_torch_gpt_o6.py``)."""
    from beforeholiday_tpu_torch.ops import quantized as tq

    base = dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4,
                n_layers=2, dtype=torch.bfloat16)
    params = gpt.init(gpt.GPTConfig(**base), _gen(63), device=cuda)
    tok, tgt = gpt.synthetic_batch(gpt.GPTConfig(**base), 2, generator=_gen(64),
                                   device=cuda)
    res = {}
    for impl in ("kernel", "torch"):
        if impl == "torch":
            monkeypatch.setattr(tq, "_fp8_mm", tq._plain_mm)
        cfg = gpt.GPTConfig(**base, attention_impl=impl, norm_impl=impl)
        m = amp.initialize(lambda p, t, cfg=cfg: gpt.forward(p, t, cfg), params,
                           FusedAdam(lr=1e-3, impl=impl), "O6", arena_native=True)
        svag = amp.scaled_value_and_grad(
            lambda p, a, b, cfg=cfg, m=m: gpt.loss_fn(p, a, b, cfg,
                                                      forward_fn=m.apply),
            m.scaler, impl=impl)
        o, s = m.optimizer.init(m.params), m.scaler.init()
        for k in tq.product_counts:
            tq.product_counts[k] = 0
        loss, g, fi, s = svag(m.params, s, tok, tgt)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        torch.cuda.synchronize()
        path = "fp8" if impl == "kernel" else "plain"
        assert tq.product_counts[f"{path}_forward"] == 8
        assert tq.product_counts[f"{path}_backward"] == 16
        assert not bool(fi) and (s["amax_history"][:, 0] > 0).all()
        res[impl] = (loss, g.arenas, o["master"], m.params.arenas, s["amax_history"])
    (lk, gk, mk, pk, hk), (lt, gt, mt_, pt, ht) = res["kernel"], res["torch"]
    torch.testing.assert_close(lk, lt, rtol=2e-3, atol=0)
    for a, b in zip(gk, gt):
        assert float((a - b).norm() / b.norm()) < 0.18
    for a, b in zip(mk, mt_):
        torch.testing.assert_close(a, b, rtol=0, atol=2.5e-3)  # up to 2 lr
    for arena, master in zip(pk, mk):
        assert torch.equal(arena, master.to(arena.dtype))
    torch.testing.assert_close(hk, ht, rtol=0.1, atol=0)


# ----------------------------------------- slice 15: tensor parallelism


def test_k2_k4_at_the_tp2_shape(cuda):
    """K2/K4 at a tensor rank's share of the flagship at TP 2: 8 local heads
    x batch 16, S 1024, D 64, causal, bf16."""
    _k2_k4_against_plain(128, 1024, 1024, 64, True, False, 0.0, [1024] * 128, 21)


@pytest.fixture
def nccl_world1(cuda, tmp_path):
    """A one-rank NCCL world through a FileStore, with model parallelism
    initialized at tensor 1 x pipe 1; destroyed after the test."""
    import torch.distributed as dist
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    ps.initialize_model_parallel(1, 1)
    try:
        yield
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def _vjp_cuda(fn, primals, dy):
    ps_ = [p.detach().clone().requires_grad_(p.is_floating_point()) for p in primals]
    out = fn(*ps_)
    return out, torch.autograd.grad(out, [p for p in ps_ if p.requires_grad], dy)


def test_tp_layers_at_world1_are_bitwise_dense(nccl_world1):
    """At a tensor world of one, over NCCL, every TP layer and region is its
    dense counterpart bit for bit, forward and backward, and the TP GPT's
    forward is the dense forward."""
    from beforeholiday_tpu_torch.ops.normalization import fused_layer_norm
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp
    from beforeholiday_tpu_torch.transformer.layers import sp_fused_layer_norm

    g = _gen(31)
    x = torch.randn(4, 256, 512, generator=g, device="cuda").bfloat16()
    xs = x.transpose(0, 1).contiguous()
    w = (0.05 * torch.randn(512, 768, generator=g, device="cuda")).bfloat16()
    b = torch.randn(768, generator=g, device="cuda").bfloat16()
    wo = (0.05 * torch.randn(512, 512, generator=g, device="cuda")).bfloat16()
    bo = torch.randn(512, generator=g, device="cuda").bfloat16()
    dense = lambda x_, w_, b_: x_ @ w_ + b_  # noqa: E731
    cases = [
        (lambda *a: tp.column_parallel_linear(*a), dense, [x, w, b]),
        (lambda *a: tp.column_parallel_linear(*a, gather_output=True), dense, [x, w, b]),
        (lambda *a: tp.column_parallel_linear(*a, sequence_parallel=True), dense, [xs, w, b]),
        (lambda *a: tp.row_parallel_linear(*a), dense, [x, wo, bo]),
        (lambda *a: tp.row_parallel_linear(*a, input_is_parallel=False), dense, [x, wo, bo]),
        (lambda *a: tp.row_parallel_linear(*a, sequence_parallel=True), dense, [xs, wo, bo]),
        (lambda x_, s_, b_: sp_fused_layer_norm(x_, s_, b_, sequence_parallel=True),
         lambda x_, s_, b_: fused_layer_norm(x_, s_, b_),
         [xs, torch.rand(512, device="cuda") + 0.5, torch.randn(512, device="cuda")]),
    ]
    for fn in (tp.copy_to_tensor_model_parallel_region,
               tp.reduce_from_tensor_model_parallel_region,
               tp.scatter_to_tensor_model_parallel_region,
               tp.gather_from_tensor_model_parallel_region,
               tp.scatter_to_sequence_parallel_region,
               tp.gather_from_sequence_parallel_region,
               tp.reduce_scatter_to_sequence_parallel_region):
        cases.append((fn, lambda t: t * 1, [x]))
    tokens = torch.randint(0, 1000, (4, 256), generator=g, device="cuda")
    table = torch.randn(1000, 512, generator=g, device="cuda").bfloat16()
    cases.append((lambda t_: tp.vocab_parallel_embedding(tokens, t_, vocab_size=1000),
                  lambda t_: t_[tokens], [table]))
    for i, (fn, ref, primals) in enumerate(cases):
        with torch.no_grad():
            dy = torch.randn(fn(*primals).shape, generator=g, device="cuda").bfloat16()
        out, grads = _vjp_cuda(fn, primals, dy)
        rout, rgrads = _vjp_cuda(ref, primals, dy)
        torch.cuda.synchronize()
        assert torch.equal(out, rout), f"case {i}: forward"
        assert all(torch.equal(a, b_) for a, b_ in zip(grads, rgrads)), f"case {i}: grads"
    # the GPT: the TP forward at world one is the dense forward
    cfg = gpt.GPTConfig(vocab_size=512, seq_len=128, d_model=256, n_heads=4,
                        n_layers=2, dtype=torch.bfloat16)
    params = amp.frontend._cast_params(gpt.init(cfg, _gen(32), device="cuda"),
                                       amp.frontend.opt_levels["O5"], None)
    tok = torch.randint(0, 512, (2, 128), generator=_gen(33), device="cuda")
    got = gpt.forward(params, tok, cfg)
    got_sp = gpt.forward(params, tok, dataclasses.replace(cfg, sequence_parallel=True))
    ps.destroy_model_parallel()
    want = gpt.forward(params, tok, cfg)
    ps.initialize_model_parallel(1, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_sp, want)


# ------------------------------------------------- K6 and K10 views mode


def _views_leaves(cuda, dtype, seed):
    """AWKWARD's leaves as separate gradient tensors (sizes around the
    4096-element block), and zero-padded fp32 arenas of their spec."""
    g = _gen(seed)
    leaves = [torch.randn(s, generator=g, device=cuda).to(dtype) for s in AWKWARD]
    spec = make_spec(AWKWARD)
    n = spec.padded_total

    def arena(scale, rand=torch.randn):
        a = torch.zeros(n, device=cuda)
        a[: spec.total] = scale * rand(spec.total, generator=g, device=cuda)
        return a

    return leaves, spec, arena


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("copy", [torch.bfloat16, None])
@pytest.mark.parametrize("skip", [False, True])
def test_k6_views_mode_bitwise_arena_launch(cuda, gdtype, copy, skip):
    """K6's views mode reads the leaves where they lie: bitwise the arena
    launch on the packed gradients (the same per-element arithmetic), the
    tail padding untouched, and within test_k6_matches_plain's tolerance of
    the per-leaf plain version; on found_inf nothing moves."""
    from beforeholiday_tpu_torch.ops.arena import flatten

    leaves, spec, arena = _views_leaves(cuda, gdtype, 31)
    p, m, v = arena(1.0), arena(0.1), arena(0.01, torch.rand)
    step = torch.full((), 3, dtype=torch.int32, device=cuda)
    bc1, bc2 = tmt._bias_corrections(True, step, 0.9, 0.999)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, bc1=bc1, bc2=bc2,
              weight_decay=0.01, adam_w_mode=True, grad_scale=0.5,
              found_inf=torch.tensor(skip, device=cuda))
    runs = {}
    for name in ("views", "arena", "plain"):
        st = (p.clone(), m.clone(), v.clone())
        c = None if copy is None else torch.zeros(spec.padded_total, dtype=copy,
                                                  device=cuda)
        if name == "views":
            before = tmt.adam_views_kernel.launches
            tmt.adam_views_kernel(leaves, *st, spec, copy_out=c, **kw)
            assert tmt.adam_views_kernel.launches == before + 1
        elif name == "arena":
            tmt.adam_kernel(flatten(leaves)[0], *st, copy_out=c, **kw)
        else:
            tmt.adam_views_torch(leaves, *st, spec, copy_out=c, **kw)
        runs[name] = st + (() if c is None else (c,))
    torch.cuda.synchronize()
    for a, b in zip(runs["views"], runs["arena"]):
        assert torch.equal(a, b)
    # p, m and v (the plain version writes the copy even on a skip, where
    # the kernels mask every store)
    for a, b in zip(runs["views"][:3], runs["plain"][:3]):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-6, atol=1e-7)
    if skip:
        assert torch.equal(runs["views"][0], p)
        assert copy is None or not runs["views"][3].any()
    assert torch.all(runs["views"][0][spec.total:] == 0)


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("first_run", [True, False])
@pytest.mark.parametrize("nesterov", [False, True])
def test_k10_views_mode_bitwise_arena_launch(cuda, pdtype, first_run, nesterov):
    """K10's views mode: bitwise the arena launch on the packed gradients
    (fp32 or bf16 params, the first-step momentum seed, Nesterov), within
    the plain per-leaf version's fma tolerance."""
    from beforeholiday_tpu_torch.ops.arena import flatten

    leaves, spec, arena = _views_leaves(cuda, torch.bfloat16, 32)
    p, mom = arena(1.0).to(pdtype), arena(0.1)
    kw = dict(lr=0.05, weight_decay=1e-4, momentum=0.9, dampening=0.0,
              nesterov=nesterov, first_run=torch.tensor(first_run, device=cuda),
              wd_after_momentum=False, scale=0.25,
              found_inf=torch.tensor(False, device=cuda))
    runs = {}
    for name in ("views", "arena", "plain"):
        st = (p.clone(), mom.clone())
        c = torch.zeros(spec.padded_total, dtype=torch.bfloat16, device=cuda)
        if name == "views":
            tmt.sgd_views_kernel(leaves, *st, spec, copy_out=c, **kw)
        elif name == "arena":
            tmt.sgd_kernel(flatten(leaves)[0], *st, copy_out=c, **kw)
        else:
            tmt.sgd_views_torch(leaves, *st, spec, copy_out=c, **kw)
        runs[name] = st + (c,)
    torch.cuda.synchronize()
    for a, b in zip(runs["views"], runs["arena"]):
        assert torch.equal(a, b)
    tol = BF16_TOL if pdtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-7)
    for a, b in zip(runs["views"], runs["plain"]):
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_views_tables_built_once_per_gradient_addresses(cuda):
    """The (pointer, count, offset) table is built once per tuple of
    gradient addresses; the block map once per tuple of sizes."""
    leaves, spec, arena = _views_leaves(cuda, torch.float32, 33)
    p, m = arena(1.0), arena(0.1)
    kw = dict(lr=0.05, weight_decay=0.0, momentum=0.9, dampening=0.0,
              nesterov=False, first_run=False, wd_after_momentum=False, scale=1.0,
              found_inf=None, copy_out=None)
    tmt.sgd_views_kernel(leaves, p, m, spec, **kw)
    built = tmt.views_tables_built[0]
    tmt.sgd_views_kernel(leaves, p, m, spec, **kw)
    assert tmt.views_tables_built[0] == built
    tmt.sgd_views_kernel([t.clone() for t in leaves], p, m, spec, **kw)
    assert tmt.views_tables_built[0] == built + 1


@pytest.mark.parametrize("what", ["strided", "mixed_dtypes", "cpu_leaf", "count"])
def test_views_mode_refuses_what_it_does_not_take(cuda, what):
    leaves, spec, arena = _views_leaves(cuda, torch.float32, 34)
    p, m = arena(1.0), arena(0.1)
    if what == "strided":
        leaves[4] = torch.randn(2 * 70000, device=cuda)[::2]
    elif what == "mixed_dtypes":
        leaves[1] = leaves[1].to(torch.bfloat16)
    elif what == "cpu_leaf":
        leaves[0] = leaves[0].cpu()
    else:
        leaves = leaves[:-1]
    with pytest.raises(ValueError):
        tmt.sgd_views_kernel(leaves, p, m, spec, lr=0.05, weight_decay=0.0,
                             momentum=0.9, dampening=0.0, nesterov=False,
                             first_run=False, wd_after_momentum=False, scale=1.0,
                             found_inf=None, copy_out=None)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_step_in_backward_on_the_card_bitwise_arena_step(cuda, opt):
    """The optimizers' view path on the card (K6/K10 views mode) through
    step_in_backward: bitwise the arena step on the packed gradients; an
    inf in one leaf skips every element and the count."""
    from beforeholiday_tpu_torch.ops.arena import flatten

    leaves, spec, arena = _views_leaves(cuda, torch.bfloat16, 35)
    make = {"adam": lambda: FusedAdam(lr=1e-3, weight_decay=0.01),
            "sgd": lambda: FusedSGD(0.05, 0.9)}[opt]
    p0 = arena(1.0)
    res = []
    for views in (True, False):
        o = make()
        p = p0.clone()
        st = o.init_flat(p)
        if views:
            p, st, flag = o.step_in_backward(p, leaves, st, spec=spec,
                                             grad_scale=0.5, bucket_bytes=1 << 16)
            assert not bool(flag)
        else:
            p, st = o.step_flat(p, flatten(leaves)[0], st, spec=spec, grad_scale=0.5)
        res.append((p, st))
    (p1, s1), (p2, s2) = res
    assert torch.equal(p1, p2) and all(torch.equal(s1[k], s2[k]) for k in s1)
    bad = [t.clone() for t in leaves]
    bad[3][17] = float("inf")
    o = make()
    p = p0.clone()
    st = o.init_flat(p)
    p, st, flag = o.step_in_backward(p, bad, st, spec=spec, bucket_bytes=1 << 16)
    assert bool(flag) and torch.equal(p, p0) and int(st["step"]) == 0


# ------------------------------------------------- Mixture-of-Experts (slice 22)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_moe_layer_on_the_card_matches_dense_oracle(cuda, dtype):
    """``moe_layer`` (slots moved by index, the grouped GEMMs on cuBLAS)
    against the port's ``dense_oracle`` on the card at capacity factor 8
    (no drops): fp32 rtol 1e-5, atol 1e-6 of the largest value; bf16 one
    ulp, atol 2^-7 of the largest (a row's GEMM at C rows and at T rows may
    round apart)."""
    from beforeholiday_tpu_torch import moe

    g = _gen(90)
    E, D, F, T = 4, 128, 512, 512
    params = moe.init_experts(g, E, D, F)
    w = torch.randn(D, E, generator=g, device=cuda) * 0.1
    x = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    cfg = moe.MoEConfig(E, 2, 8.0)
    y, aux = moe.moe_layer(x, w, params, cfg)
    ref, aux_ref = moe.dense_oracle(x, w, params, cfg)
    assert float(aux["moe_drop_fraction"]) == 0.0
    assert torch.equal(aux["moe_aux_loss"], aux_ref["moe_aux_loss"])
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2 ** -7, 2 ** -7)
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol,
                               atol=atol * float(ref.float().abs().max()))


def test_moe_step_kernels_match_plain_path(cuda, monkeypatch):
    """One O5 arena-native step of a 2-layer bf16 GPT with one MoE block on
    K1-K6 against the same step with every op on its plain version; the
    objective ``loss_and_aux``'s. The plain step routes on the kernel
    step's router logits (their values; the gradient flows through its
    own), so a token whose top-2 margin sits within the bf16 noise between
    the kernels and their plain versions takes the same experts on both
    paths and the gradients hold at the dense step's elementwise bounds.
    The top-2 choices the plain step's own logits would have changed are
    counted and reported beside the relative L2 of the gradient arenas."""
    from beforeholiday_tpu_torch.moe import dispatch

    base = dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4, n_layers=2,
                dtype=torch.bfloat16, moe_every=2, moe_experts=4)
    params = gpt.init(gpt.GPTConfig(**base), _gen(0), device=cuda)
    tok, tgt = gpt.synthetic_batch(gpt.GPTConfig(**base), 2, generator=_gen(1),
                                   device=cuda)
    real_logits = dispatch.router_logits
    logits = {"kernel": [], "torch": []}

    def routed_on(impl):
        def router_logits(x, w):
            own = real_logits(x, w)
            logits[impl].append(own.detach().clone())
            if impl == "kernel":
                return own
            # the kernel step's values exactly (own - own is 0), own's gradient
            return logits["kernel"][len(logits[impl]) - 1] + (own - own.detach())
        return router_logits

    res = {}
    for impl in ("kernel", "torch"):
        monkeypatch.setattr(dispatch, "router_logits", routed_on(impl))
        cfg = gpt.GPTConfig(**base, attention_impl=impl, norm_impl=impl)
        m = amp.initialize(lambda p, a, b, cfg=cfg: gpt.loss_and_aux(p, a, b, cfg), params,
                           FusedAdam(lr=1e-3, impl=impl), "O5", arena_native=True)
        svag = amp.scaled_value_and_grad(lambda p, a, b, m=m: m.apply(p, a, b)[0],
                                         m.scaler, impl=impl)
        o, s = m.optimizer.init(m.params), m.scaler.init()
        counters = (tnorm.ln_bwd_kernel, tattn.flash_bwd_kernel, tmt.scale_kernel,
                    tmt.adam_kernel)
        before = [fn.launches for fn in counters]
        loss, g, fi, s = svag(m.params, s, tok, tgt)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        torch.cuda.synchronize()
        launched = [fn.launches - b for fn, b in zip(counters, before)]
        assert launched == ([5, 2, 2, 2] if impl == "kernel" else [0, 0, 0, 0])
        res[impl] = (loss, g.arenas, o["master"], m.params.arenas)
    assert len(logits["kernel"]) == len(logits["torch"]) > 0
    # (token) rows whose ordered top-2 experts differ between the two paths'
    # own logits: the choices pinning keeps from flipping
    flips = sum(int((torch.topk(a, 2).indices != torch.topk(b, 2).indices).any(1).sum())
                for a, b in zip(logits["kernel"], logits["torch"]))
    (lk, gk, mk, pk), (lt, gt, mt_, pt) = res["kernel"], res["torch"]
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(gk, gt)]
    print(f"moe step: top-2 flips {flips} of {tok.numel()} tokens, "
          f"grad arenas rel L2 {rel}")
    torch.testing.assert_close(lk, lt, rtol=2e-3, atol=0)
    for a, b in zip(gk, gt):
        torch.testing.assert_close(a, b, rtol=0.05, atol=2e-2 * float(b.abs().max()),
                                   msg=lambda m: f"{m} (flips {flips}, rel L2 {rel})")
    for a, b in zip(mk, mt_):
        torch.testing.assert_close(a, b, rtol=0, atol=2.5e-3)  # up to 2 lr
    for arena, master in zip(pk, mk):
        assert torch.equal(arena, master.to(arena.dtype))


def _a2a_round_trip_rank(rank, store, out):
    """A rank of a gloo world of 2 on CUDA tensors: the differentiable
    tiled exchange (E, C, D) -> (E / 2, 2 C, D), its backward, and the
    inverse exchange back."""
    import torch.distributed as dist
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        mesh = ps.make_moe_mesh(expert=2)
        with mesh:
            g = torch.Generator(device="cuda").manual_seed(rank)
            x = torch.randn(4, 3, 8, generator=g, device="cuda").requires_grad_(True)
            y = comms.all_to_all_differentiable(x, "expert", 0, 1, site="t.a2a")
            back = comms.all_to_all(y.detach(), "expert", 1, 0, site="t.a2a", tiled=True)
            ct = torch.randn(y.shape, generator=g, device="cuda")
            y.backward(ct)
            want = comms.all_to_all(ct, "expert", 1, 0, site="t.a2a", tiled=True)
            ok = (y.is_cuda and y.shape == (2, 6, 8) and torch.equal(back, x.detach())
                  and torch.equal(x.grad, want))
        mesh.destroy()
        torch.save({"ok": bool(ok), "y": y.detach().cpu(), "x": x.detach().cpu()},
                   f"{out}/a2a{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_all_to_all_round_trip_through_gloo_on_the_card(cuda, tmp_path):
    """Two gloo ranks on CUDA tensors: the exchange and its inverse restore
    each rank's tensor bitwise, the backward is the inverse exchange, and
    rank r's result holds every rank's chunk r in rank order."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_a2a_round_trip_rank,
                         args=(r, f"{tmp_path}/store", str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0, 0]
    res = [torch.load(f"{tmp_path}/a2a{r}.pt") for r in range(2)]
    assert all(r["ok"] for r in res)
    for r in range(2):
        want = torch.cat([res[s]["x"][2 * r:2 * r + 2] for s in range(2)], dim=1)
        assert torch.equal(res[r]["y"], want)


def test_snapshot_submitted_before_a_step_holds_the_state_before_it(nccl_world1,
                                                                    tmp_path):
    """An async checkpoint copies the ZeRO-3 shard to pinned host buffers on
    a side stream while K6 updates it in place: each generation submitted
    before a step holds the state from before that step (the step waits for
    the copy), and the steps' results are bitwise those of a run that never
    checkpointed. The buffers are reused across generations."""
    from beforeholiday_tpu_torch.elastic import CheckpointManager
    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam, zero3

    g = _gen(5)
    # a 256 MB fp32 arena: its copy to the host takes milliseconds, while
    # the step launched right after the submit would overtake it
    params = {"w": torch.randn(8192, 8192, generator=g, device="cuda")}
    layout = zero3.layout_of(params)
    grads = [torch.randn(layout.spec.padded_total, generator=g, device="cuda")
             for _ in range(4)]
    opt = ZeRO3FusedAdam(lr=1e-2)
    ref = opt.init(params)
    state = opt.init(params)
    assert state["master"].is_cuda
    want = []
    with CheckpointManager(str(tmp_path), zero3.shard_manifest(layout, 1), rank=0,
                           token="t", queue_depth=2, keep=4) as mgr:
        for i, gr in enumerate(grads):
            want.append({k: v.cpu() for k, v in state.items()})
            mgr.submit(i, state)
            state = opt.step(gr, state)
            ref = opt.step(gr, ref)
        mgr.wait()
        assert len(mgr._buffers) == 2 and all(
            b["master"].is_pinned() for b in mgr._buffers.values())
    assert not zero3._FENCES
    for i, w in enumerate(want):
        manifest, shards = zero3.load_shard_files(f"{tmp_path}/gen_{i:08d}")
        for k in ("master", "exp_avg", "exp_avg_sq", "step"):
            assert np.array_equal(shards[0][k], w[k].numpy()), (i, k)
    for k in ("master", "exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(state[k], ref[k])
