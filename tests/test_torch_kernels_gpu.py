"""Kernels K1 (LayerNorm forward, Triton) and K2 (flash-attention forward,
CUDA C++) against their plain PyTorch versions on the card.

Marked ``gpu``: without a CUDA device every test skips (the decision is made
inside the ``cuda`` fixture, never at import, so every pytest worker collects
the same tests). Run on an H100 with::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the repo's conftest imports JAX, which the card's machine
does not need.) Tolerances, and why, are tabulated in PERF.md.
"""

import numpy as np
import pytest
import torch

from beforeholiday_tpu_torch.infer import EngineConfig, InferenceEngine, PageAllocator, pages_for
from beforeholiday_tpu_torch.ops import attention as tattn
from beforeholiday_tpu_torch.ops import normalization as tnorm
from beforeholiday_tpu_torch.testing import gpt

pytestmark = pytest.mark.gpu

# bf16 outputs: kernel and plain version both compute in fp32 and round once,
# so they may differ by one bf16 ulp (relative 2**-7) where the fp32 values
# straddle a rounding boundary
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)
FP32_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1/K2 run only on the card)")
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
