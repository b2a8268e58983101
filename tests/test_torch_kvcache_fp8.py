"""Port parity: fp8 (e4m3) KV pages (``infer/kvcache.py``'s quantized
variants and the engine on ``cache_dtype="e4m3"``), held against the JAX
package (``tests/test_serving.py``'s fp8 class) on the same numpy inputs and
weights, on the CPU.

The page writes, the scales and the gather agree bit for bit; the bounds
are the same numbers; the e4m3 engine's greedy tokens are JAX's and its
logits agree within fp32 GEMM reordering (PERF.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import infer as jinfer
from beforeholiday_tpu.infer import kvcache as jkv
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import infer as tinfer
from beforeholiday_tpu_torch.infer import kvcache as tkv
from beforeholiday_tpu_torch.testing import gpt as tgpt

LAYOUT = dict(n_layers=1, n_pages=7, page_size=4, kv_dim=8)
TINY = dict(vocab_size=64, seq_len=64, d_model=32, n_heads=2, n_layers=2)
ECFG = dict(max_seq_len=32, page_size=8, num_pages=17, batch_buckets=(2,),
            prefill_seq_buckets=(8, 16))
# fp32 logits of the two packages' fp32 GEMMs and fp32 attention on the same
# dequantized pages: the fp32 serving tests' bound (test_torch_serving.py);
# measured 8.9e-8 (PERF.md)
LOGIT_ATOL = 1e-4


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _pools():
    t = tkv.alloc_cache(tkv.PagedLayout(dtype_name="e4m3", **LAYOUT), "cpu")
    j = jkv.alloc_cache(jkv.PagedLayout(dtype_name="e4m3", **LAYOUT))
    return (t.k[0], t.k_scale[0]), (j.k[0], j.k_scale[0])


def _live(a):
    """Pages and scales but the null page, where duplicate writes of
    padding rows may land in any order."""
    return a[1:]


def test_page_writes_and_gather_bitwise():
    """Prefill (one scale a page chunk, a padding row on the null table),
    then a decode write that opens a page, one mid-page and a padding row's:
    the live pages' bytes, their scales and the dequantized gather equal
    JAX's bit for bit."""
    (tp, ts), (jp, js) = _pools()
    rng = np.random.RandomState(0)
    vals = (rng.randn(3, 8, 8) * np.array([3.0, 0.02, 1.0])[:, None, None]
            ).astype(np.float32)
    table = np.array([[1, 2, 5], [3, 4, 6], [0, 0, 0]], np.int32)
    tkv.write_prefill_quantized(tp, ts, torch.from_numpy(table), torch.from_numpy(vals))
    jp, js = jkv.write_prefill_quantized(jp, js, jnp.asarray(table), jnp.asarray(vals))
    np.testing.assert_array_equal(_live(_bits(tp)), _live(_bits(jp)))
    np.testing.assert_array_equal(_live(ts.numpy()), _live(np.asarray(js)))
    pos = np.array([8, 5, 0], np.int32)  # opens page 5; mid-page 4; padding
    tok = (rng.randn(3, 8) * 4.0).astype(np.float32)
    tkv.write_token_quantized(tp, ts, torch.from_numpy(table), torch.from_numpy(pos),
                              torch.from_numpy(tok))
    jp, js = jkv.write_token_quantized(jp, js, jnp.asarray(table), jnp.asarray(pos),
                                       jnp.asarray(tok))
    np.testing.assert_array_equal(_live(_bits(tp)), _live(_bits(jp)))
    np.testing.assert_array_equal(_live(ts.numpy()), _live(np.asarray(js)))
    live = table[:2]
    got = tkv.gather_pages_quantized(tp, ts, torch.from_numpy(live))
    ref = jkv.gather_pages_quantized(jp, js, jnp.asarray(live))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the mid-page write kept its page's prefill scale
    assert ts[4] == float(np.asarray(js)[4]) and float(ts[5]) != 1.0
    with pytest.raises(ValueError, match="multiple of page_size"):
        tkv.write_prefill_quantized(tp, ts, torch.from_numpy(table),
                                    torch.zeros(3, 6, 8))


def test_prefill_roundtrip_within_dequant_bound():
    (tp, ts), _ = _pools()
    vals = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 8).astype(
        np.float32)) * 3.0
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    tkv.write_prefill_quantized(tp, ts, table, vals)
    back = tkv.gather_pages_quantized(tp, ts, table)
    s = ts[table.long()].repeat_interleave(4, dim=1)[:, :, None]
    err = (back - vals).abs()
    assert (err <= tkv.kv_dequant_error_bound(vals, s)).all()
    assert float(err.max()) > 0.0


def test_scale_freezes_at_page_open_then_saturates():
    (tp, ts), _ = _pools()
    table = torch.tensor([[1, 0]], dtype=torch.int32)
    tkv.write_token_quantized(tp, ts, table, torch.tensor([0]),
                              torch.full((1, 8), 1.0))
    frozen = float(ts[1])
    assert frozen == 448.0 / tkv.KV_SCALE_MARGIN
    big = torch.full((1, 8), 100.0)
    tkv.write_token_quantized(tp, ts, table, torch.tensor([1]), big)
    assert float(ts[1]) == frozen
    back = tkv.gather_pages_quantized(tp, ts, table)
    assert float(back[0, 0, 0]) == 1.0 and float(back[0, 1, 0]) == tkv.KV_SCALE_MARGIN
    assert abs(float(back[0, 1, 0]) - 100.0) <= float(
        tkv.kv_dequant_error_bound(big[0], ts[1])[0])


def test_null_page_dequantizes_to_zero():
    (tp, ts), _ = _pools()
    ts.fill_(3.7)  # under any scale
    back = tkv.gather_pages_quantized(tp, ts, torch.zeros((1, 2), dtype=torch.int32))
    assert float(back.abs().max()) == 0.0


def test_bounds_equal_jax():
    v = np.random.RandomState(1).randn(4, 8).astype(np.float32) * 50
    s = np.array([[1.0], [4.48], [0.5], [200.0]], np.float32)
    np.testing.assert_array_equal(tkv.kv_dequant_error_bound(v, s).numpy(),
                                  np.asarray(jkv.kv_dequant_error_bound(v, s)))
    for step, n, ceil in ((0, 2, 10.0), (5, 2, 10.0), (3, 8, 17.5)):
        assert tkv.kv_logit_error_bound(step, n_layers=n, logit_ceiling=ceil) == \
            jkv.kv_logit_error_bound(step, n_layers=n, logit_ceiling=ceil)
    with pytest.raises(ValueError):
        tkv.kv_logit_error_bound(0, n_layers=0, logit_ceiling=10.0)


def test_layout_validation_and_page_bytes():
    for name in ("e4m3", "float32"):
        t, j = (m.PagedLayout(dtype_name=name, **LAYOUT) for m in (tkv, jkv))
        assert t.quantized == j.quantized == (name == "e4m3")
        assert t.page_bytes == j.page_bytes
        assert t.usable_pages == j.usable_pages
        assert t.tokens_per_layer == j.tokens_per_layer
    t8 = tkv.PagedLayout(dtype_name="e4m3", **LAYOUT)
    t32 = tkv.PagedLayout(dtype_name="float32", **LAYOUT)
    assert t32.page_bytes / t8.page_bytes >= 1.8
    assert t8.dtype == torch.float8_e4m3fn
    with pytest.raises(NotImplementedError):
        tkv.PagedLayout(dtype_name="not_a_dtype", **LAYOUT)
    cache = tkv.alloc_cache(t8, "cpu")
    assert cache.k_scale.shape == cache.v_scale.shape == (1, 7)
    assert (cache.k_scale == 1.0).all() and not cache.flat.view(torch.uint8).any()
    assert tkv.alloc_cache(t32, "cpu").k_scale is None


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
    for dt in ("e4m3", "float32"):
        je = jinfer.InferenceEngine(jparams, jcfg, jinfer.EngineConfig(
            **ECFG, cache_dtype=dt, entry_prefix=f"torch_fp8_{dt}"))
        te = tinfer.InferenceEngine(tparams, tcfg, tinfer.EngineConfig(
            **ECFG, cache_dtype=dt), device="cpu")
        out[dt] = (je, te)
    return out


def _drive(engine, prompts, n_new, logits=False):
    """Prefill and greedy decode through the host API; with ``logits``, each
    decode step's logits too."""
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
        if logits:
            steps.append(np.asarray(engine.decode_logits(toks, lens, tables)))
        toks = np.asarray(engine.decode(toks, lens, tables)).tolist()
        for i, t in enumerate(toks):
            outs[i].append(t)
            lens[i] += 1
    return outs, steps


PROMPTS = [[5, 9, 2, 7, 1, 3], [11, 4, 8]]


def test_e4m3_engine_matches_jax(engines):
    """Greedy tokens identical, every decode step's logits within
    LOGIT_ATOL, across page boundaries (8-token pages, 10 new tokens)."""
    je, te = engines["e4m3"]
    je.reset_cache()
    te.reset_cache()
    jt, jl = _drive(je, PROMPTS, 10, logits=True)
    tt, tl = _drive(te, PROMPTS, 10, logits=True)
    assert tt == jt
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=LOGIT_ATOL, rtol=0)
    assert te.layout.quantized and te._cache.k.dtype == torch.float8_e4m3fn


def test_e4m3_engine_against_fp32_pages(engines):
    """The same prompts on fp32 pages: the greedy tokens agree, and the
    first decode step's logits lie within ``kv_logit_error_bound``, as the
    JAX test holds them."""
    (_, t8), (_, t32) = engines["e4m3"], engines["float32"]
    for e in (t8, t32):
        e.reset_cache()
    assert _drive(t8, PROMPTS, 8)[0] == _drive(t32, PROMPTS, 8)[0]
    logits = []
    for e in (t32, t8):
        e.reset_cache()
        table = [jinfer.PageAllocator(17).alloc(1)]
        e.prefill([PROMPTS[0][:5]], table)
        logits.append(e.decode_logits([7], [5], table))
    dev = float(np.abs(logits[0] - logits[1]).max())
    bound = tkv.kv_logit_error_bound(0, n_layers=TINY["n_layers"],
                                     logit_ceiling=float(np.abs(logits[0]).max()))
    assert 0.0 < dev <= bound


def test_e4m3_padding_rows_cannot_perturb_live_rows(engines):
    _, te = engines["e4m3"]
    p0, p1 = [3, 1, 4, 1], [9, 2, 6, 5]
    got = []
    for live in (1, 2):
        te.reset_cache()
        alloc = jinfer.PageAllocator(te.cfg.num_pages)
        t0, t1 = alloc.alloc(1), alloc.alloc(1)
        te.prefill([p0, p1], [t0, t1])
        got.append(te.decode_logits([7, 8][:live], [4, 4][:live], [t0, t1][:live]))
    np.testing.assert_array_equal(got[0][0], got[1][0])


def test_e4m3_copy_pages_carries_the_scales(engines):
    """``copy_pages`` duplicates the pages' bytes and their scale planes in
    every layer, so the copy dequantizes to the source."""
    _, te = engines["e4m3"]
    te.reset_cache()
    te.prefill([PROMPTS[0]], [[1]])
    te.copy_pages([1], [5])
    c = te._cache
    for pool in (c.k, c.v):
        assert torch.equal(pool[:, 5].view(torch.uint8), pool[:, 1].view(torch.uint8))
    for plane in (c.k_scale, c.v_scale):
        assert torch.equal(plane[:, 5], plane[:, 1]) and (plane[:, 1] != 1.0).all()
    for i in range(TINY["n_layers"]):
        a = tkv.gather_pages_quantized(c.k[i], c.k_scale[i], torch.tensor([[1]]))
        b = tkv.gather_pages_quantized(c.k[i], c.k_scale[i], torch.tensor([[5]]))
        assert torch.equal(a, b)
