"""Kernels K1/K3 (LayerNorm forward/backward, Triton), K2/K4 (flash
attention forward/backward, CUDA C++), K5 (unscale), K6 (fused Adam), K7
(LAMB stage 1), K8 (trust-ratio update), K9 (global sum of squares), K10
(fused SGD) and K11/K12 (scaled masked softmax forward/backward), all
Triton, against their plain PyTorch versions on the card, and the engine
and small O5 GPT (FusedAdam; flash and unfused attention), BERT (FusedLAMB;
both attentions) and ResNet (FusedSGD) training steps on the kernels
against the plain path.

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
from beforeholiday_tpu_torch.infer import EngineConfig, InferenceEngine, PageAllocator, pages_for
from beforeholiday_tpu_torch.ops import attention as tattn
from beforeholiday_tpu_torch.ops import multi_tensor as tmt
from beforeholiday_tpu_torch.ops import normalization as tnorm
from beforeholiday_tpu_torch.ops import softmax as tsm
from beforeholiday_tpu_torch.ops.arena import make_spec
from beforeholiday_tpu_torch.optimizers import FusedAdam, FusedLAMB
from beforeholiday_tpu_torch.testing import bert, gpt

pytestmark = pytest.mark.gpu

# bf16 outputs: kernel and plain version both compute in fp32 and round once,
# so they may differ by one bf16 ulp (relative 2**-7) where the fp32 values
# straddle a rounding boundary
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)
FP32_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1-K12 run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("rows, hidden, dtype, rms, out_dtype", [
    (8192, 1024, torch.bfloat16, False, torch.bfloat16),  # prefill
    (32, 1024, torch.bfloat16, False, torch.bfloat16),    # decode
    (300, 1024, torch.float32, False, torch.float32),
    (300, 1024, torch.float32, True, torch.float32),
    (77, 1000, torch.float32, False, torch.float32),      # odd width
    (64, 1000, torch.bfloat16, True, torch.float32),      # mixed dtype
])
def test_k1_matches_plain(cuda, rows, hidden, dtype, rms, out_dtype):
    g = _gen(0)
    x = (torch.randn(rows, hidden, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(hidden, generator=g, device=cuda)
    b = None if rms else 0.1 * torch.randn(hidden, generator=g, device=cuda)
    before = tnorm.ln_fwd_kernel.launches
    got = tnorm.ln_fwd_kernel(x, w, b, 1e-5, rms, out_dtype)
    assert tnorm.ln_fwd_kernel.launches == before + 1
    ref = tnorm.ln_fwd_torch(x, w, b, 1e-5, rms, out_dtype)
    torch.cuda.synchronize()
    tol = BF16_TOL if out_dtype == torch.bfloat16 else FP32_TOL
    torch.testing.assert_close(got, ref, **tol)


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
    torch.testing.assert_close(o, ro, **(BF16_TOL if dtype == torch.bfloat16
                                         else FP32_TOL))
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("D, dtypes", [
    (72, (torch.float32,) * 3),                                  # head dim
    (64, (torch.bfloat16, torch.float32, torch.float32)),        # mixed
    (64, (torch.float16,) * 3),                                  # dtype
])
def test_k2_refuses_what_it_does_not_take(cuda, D, dtypes):
    q, k, v = (torch.zeros(2, 8, D, device=cuda, dtype=dt) for dt in dtypes)
    lens = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tattn.flash_fwd_kernel(q, k, v, lens, False, 0.1)


# ------------------------------------------------------------ the engine


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
])
def test_k3_matches_plain(cuda, rows, hidden, dtype, rms, bias):
    g = _gen(1)
    x = (torch.randn(rows, hidden, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    dy = torch.randn(rows, hidden, generator=g, device=cuda).to(dtype)
    w = 1 + 0.1 * torch.randn(hidden, generator=g, device=cuda)
    before = tnorm.ln_bwd_kernel.launches
    dx, dw, db = tnorm.ln_bwd_kernel(x, w, dy, 1e-5, rms, bias)
    assert tnorm.ln_bwd_kernel.launches == before + 1
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
    # (as the TPU kernel does); the plain version keeps them fp32
    if dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2 * float(ref.float().abs().max()))
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
def test_k10_matches_plain(cuda, n, copy, first, skip, variant):
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
    p = torch.randn(n, generator=g, device=cuda)
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
        assert torch.equal(pk, p) and torch.equal(mk, m) and torch.equal(ck, p.to(copy))
        return
    for a, b in ((pk, pt), (mk, mt_)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
    if copy is not None:
        assert torch.equal(ck, pk.to(copy))


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
