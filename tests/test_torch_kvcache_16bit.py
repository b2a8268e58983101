"""Port parity: bf16 and fp16 KV pages (``PagedLayout(dtype_name="bfloat16" |
"float16")`` and the engine on ``cache_dtype="bfloat16" | "float16"``), held
against the JAX package on the same numpy inputs and weights, on the CPU.

The page writes (one round-to-nearest cast to the page dtype) agree bit for
bit, read as int16; the gathers return the pages' own dtype, bitwise; the
plain version of K2's paged mode on 16-bit pools matches JAX's gather +
``flash_attention``; the engines' greedy tokens are JAX's and their logits
agree within fp32 GEMM reordering (1e-4, as on fp32 pages).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import infer as jinfer
from beforeholiday_tpu.ops import attention as jattn
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import infer as tinfer
from beforeholiday_tpu_torch.ops import attention as tattn
from beforeholiday_tpu_torch.testing import gpt as tgpt

TINY = dict(vocab_size=64, seq_len=64, d_model=32, n_heads=2, n_layers=2)
ECFG = dict(max_seq_len=32, page_size=8, num_pages=17, batch_buckets=(2,),
            prefill_seq_buckets=(8, 16))
LAYOUT = dict(n_layers=2, n_pages=9, page_size=4, kv_dim=8)
DTYPES = ("bfloat16", "float16")
# fp32 logits of the two packages' fp32 GEMMs on the same page values: the
# fp32 serving tests' bound (test_torch_serving.py)
LOGIT_ATOL = 1e-4
_PREFIX = itertools.count()


def _int16(pages):
    return np.asarray(pages).view(np.int16)


@pytest.mark.parametrize("name", DTYPES)
def test_layout_dtype_and_page_bytes_match_jax(name):
    t, j = (m.PagedLayout(dtype_name=name, **LAYOUT) for m in (tinfer, jinfer))
    t32 = tinfer.PagedLayout(dtype_name="float32", **LAYOUT)
    assert t.page_bytes == j.page_bytes == t32.page_bytes // 2
    assert not t.quantized and not j.quantized
    assert t.dtype == getattr(torch, name)
    cache = tinfer.alloc_cache(t, "cpu")
    assert cache.k.dtype == cache.v.dtype == t.dtype and cache.k_scale is None
    assert cache.k.shape == (2, 9, 4, 8) and not cache.flat.view(torch.uint8).any()


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("scale", [1.0, 1e-6, 3e4])
def test_page_writes_and_gather_match_jax_bitwise(name, scale):
    """fp32 values written to 16-bit pages round once to nearest, as JAX's
    ``astype``: the live pages' bits equal, at magnitudes that hit fp16's
    subnormals (1e-6) and its overflow to inf (3e4 * a few), and the gather
    returns the same bits in the pages' dtype."""
    rng = np.random.default_rng(int(scale * 7) + len(name))
    jdt, tdt = jnp.dtype(name), getattr(torch, name)
    pages = (rng.standard_normal((6, 4, 3)) * scale).astype(np.float32)
    table = np.array([[2, 5, 0], [1, 0, 0]], np.int32)
    vals = (rng.standard_normal((2, 8, 3)) * scale).astype(np.float32)
    tok = (rng.standard_normal((2, 3)) * scale).astype(np.float32)
    pos = np.array([6, 2], np.int32)
    j = jinfer.write_prefill(jnp.asarray(pages).astype(jdt), jnp.asarray(table),
                             jnp.asarray(vals))
    j = jinfer.write_token(j, jnp.asarray(table), jnp.asarray(pos),
                           jnp.asarray(tok))
    t = torch.from_numpy(pages.copy()).to(tdt)
    tinfer.write_prefill(t, torch.from_numpy(table), torch.from_numpy(vals))
    tinfer.write_token(t, torch.from_numpy(table), torch.from_numpy(pos),
                       torch.from_numpy(tok))
    assert t.dtype == tdt
    # page 0 took colliding padding writes: its content is unspecified
    np.testing.assert_array_equal(t.view(torch.int16).numpy()[1:],
                                  _int16(j)[1:])
    got = tinfer.gather_pages(t, torch.from_numpy(table))
    ref = jinfer.gather_pages(j, jnp.asarray(table))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.view(torch.int16).numpy()[0, :8],
                                  _int16(ref)[0, :8])


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_on_16bit_pools_matches_jax(name, q_dtype):
    """The plain version of K2's paged mode reading 16-bit pools: JAX's
    engine step (gather the pages, ``flash_attention`` over them, which
    widens k and v to fp32) on the same pools, q and lengths."""
    B, H, D, P, slots = 3, 2, 16, 4, 5
    rng = np.random.default_rng(11)
    pools = [rng.standard_normal((12, P, H * D)).astype(np.float32)
             for _ in range(2)]
    q = rng.standard_normal((B, 1, H * D)).astype(np.float32)
    lens = np.array([7, 0, 20], np.int32)
    table = np.zeros((B, slots), np.int32)
    table[0, :2], table[2, :5] = [3, 9], [1, 4, 2, 11, 6]
    jp = [jnp.asarray(p).astype(name) for p in pools]
    jq = jnp.asarray(q).astype(q_dtype)
    kc, vc = (jinfer.gather_pages(p, jnp.asarray(table)) for p in jp)
    heads = lambda x: x.reshape(B, x.shape[1], H, D).transpose(0, 2, 1, 3)
    ref = jattn.flash_attention(heads(jq), heads(kc), heads(vc), causal=False,
                                scale=D ** -0.5, kv_lens=jnp.asarray(lens),
                                impl="jnp")
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(B, 1, H * D)
    tp = [torch.from_numpy(p).to(getattr(torch, name)) for p in pools]
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    got, _ = tattn._paged_decode_torch(tq, tp[0], tp[1], torch.from_numpy(table),
                                       torch.from_numpy(lens), H, D ** -0.5)
    assert got.dtype == tq.dtype
    tol = dict(atol=1e-5, rtol=1e-5) if q_dtype == "float32" else dict(
        atol=2 ** -8, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    assert not got[1].any()


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tgpt.GPTConfig(**TINY)
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def engines(models):
    jcfg, jparams, tcfg, tparams = models
    out = {}
    for dt in DTYPES:
        je = jinfer.InferenceEngine(jparams, jcfg, jinfer.EngineConfig(
            **ECFG, cache_dtype=dt, entry_prefix=f"torch_16bit_{next(_PREFIX)}"))
        te = tinfer.InferenceEngine(tparams, tcfg, tinfer.EngineConfig(
            **ECFG, cache_dtype=dt), device="cpu")
        out[dt] = (je, te)
    return out


def _drive(engine, prompts, n_new):
    """Prefill and greedy decode through the host API, each decode step's
    logits beside the tokens."""
    alloc = jinfer.PageAllocator(engine.cfg.num_pages)
    ps = engine.cfg.page_size
    tables = [alloc.alloc(jinfer.pages_for(len(p), ps)) for p in prompts]
    toks = np.asarray(engine.prefill(prompts, tables)).tolist()
    lens = [len(p) for p in prompts]
    outs, steps = [[t] for t in toks], []
    for _ in range(n_new - 1):
        for i in range(len(prompts)):
            while len(tables[i]) * ps <= lens[i]:
                tables[i] += alloc.alloc(1)
        steps.append(np.asarray(engine.decode_logits(toks, lens, tables)))
        toks = np.asarray(engine.decode(toks, lens, tables)).tolist()
        for i, t in enumerate(toks):
            outs[i].append(t)
            lens[i] += 1
    return outs, steps


PROMPTS = [[5, 9, 2, 7, 1, 3], [11, 4, 8]]


@pytest.mark.parametrize("name", DTYPES)
def test_16bit_engine_matches_jax(engines, name):
    """Greedy tokens identical and every decode step's logits within
    LOGIT_ATOL across page boundaries (8-token pages, 10 new tokens); the
    pools hold the page dtype."""
    je, te = engines[name]
    je.reset_cache()
    te.reset_cache()
    jt, jl = _drive(je, PROMPTS, 10)
    tt, tl = _drive(te, PROMPTS, 10)
    assert tt == jt
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=LOGIT_ATOL, rtol=0)
    assert te._cache.k.dtype == getattr(torch, name)


@pytest.mark.parametrize("name", DTYPES)
def test_16bit_copy_pages_duplicates_every_layer(engines, name):
    _, te = engines[name]
    te.reset_cache()
    te.prefill([PROMPTS[0]], [[1]])
    te.copy_pages([1], [5])
    for pool in (te._cache.k, te._cache.v):
        assert torch.equal(pool[:, 5], pool[:, 1]) and pool[:, 1].any()
