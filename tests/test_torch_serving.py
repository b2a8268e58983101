"""Port parity: the serving slice as a whole — GPT forward, the paged-KV
inference engine and continuous batching — held against the JAX package with
the same weights (``params_from_numpy``), plus the host-side pieces and the
port's import and device rules."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import infer as jinfer
from beforeholiday_tpu.ops import dense as jdense
from beforeholiday_tpu.ops import arena as jarena
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import infer as tinfer
from beforeholiday_tpu_torch.amp import LossScaler
from beforeholiday_tpu_torch.monitor import BucketGateError, track_compiles
from beforeholiday_tpu_torch.ops import arena as tarena
from beforeholiday_tpu_torch.ops import dense as tdense
from beforeholiday_tpu_torch.ops._autocast import cast_floats
from beforeholiday_tpu_torch.testing import gpt as tgpt

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=64, seq_len=64, d_model=32, n_heads=2, n_layers=2)
ECFG = dict(max_seq_len=32, page_size=8, num_pages=17, batch_buckets=(2, 4),
            prefill_seq_buckets=(8, 16, 32))
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tgpt.GPTConfig(**TINY)
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _engines(models, **overrides):
    jcfg, jparams, tcfg, tparams = models
    kw = {**ECFG, **overrides}
    je = jinfer.InferenceEngine(
        jparams, jcfg, jinfer.EngineConfig(**kw, entry_prefix=f"torch_parity_{id(kw)}"))
    te = tinfer.InferenceEngine(tparams, tcfg, tinfer.EngineConfig(**kw),
                                device="cpu")
    return je, te


@pytest.fixture(scope="module")
def engines(models):
    return _engines(models)


def _requests(mod, specs):
    return [mod.Request(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]


# --------------------------------------------------------------- the model


@pytest.mark.parametrize("batch, seq", [(1, 64), (3, 17)])
def test_gpt_forward_matches_jax(models, batch, seq):
    jcfg, jparams, tcfg, tparams = models
    tokens = np.random.default_rng(seq).integers(0, TINY["vocab_size"],
                                                 (batch, seq)).astype(np.int32)
    ref = np.asarray(jgpt.forward(jparams, jnp.asarray(tokens), jcfg))
    got = tgpt.forward(tparams, torch.from_numpy(tokens).long(), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_gpt_init_shapes_match_jax(models):
    jcfg, jparams, tcfg, _ = models
    mine = tgpt.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
    assert float(mine["tok_embed"].std()) == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("field, value", [
    ("moe_every", 1), ("sequence_parallel", True),
    ("remat_policy", "full"), ("moe_experts", 8),
])
def test_gpt_config_rejects_unported_paths(models, field, value):
    """The MoE and remat fields select paths not ported yet and raise.
    ``sequence_parallel`` is ported (slice 15): it builds, and without model
    parallelism it changes nothing, as in JAX."""
    if field == "sequence_parallel":
        _, _, tcfg, tparams = models
        tokens = torch.from_numpy(np.random.default_rng(6).integers(
            0, TINY["vocab_size"], (2, 20))).long()
        got = tgpt.forward(tparams, tokens, tgpt.GPTConfig(**TINY, **{field: value}))
        assert torch.equal(got, tgpt.forward(tparams, tokens, tcfg))
        return
    with pytest.raises(NotImplementedError):
        tgpt.GPTConfig(**TINY, **{field: value})


@pytest.mark.parametrize("field", ["dropout_rate", "attention_dropout"])
def test_gpt_config_accepts_dropout_rates(models, field):
    """The dropout rates build, and without a dropout key the forward is
    JAX's no-key forward (the rates act only with a key, as in JAX)."""
    jcfg, jparams, _, tparams = models
    tcfg = tgpt.GPTConfig(**TINY, **{field: 0.1})
    tokens = np.random.default_rng(5).integers(0, TINY["vocab_size"],
                                               (2, 20)).astype(np.int32)
    ref = jgpt.forward(jparams, jnp.asarray(tokens),
                       jgpt.GPTConfig(**TINY, dtype=jnp.float32, **{field: 0.1}))
    got = tgpt.forward(tparams, torch.from_numpy(tokens).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_gpt_unfused_config_builds_and_runs(models):
    """The unfused attention (``use_flash_attention=False``) builds and its
    forward runs."""
    cfg = tgpt.GPTConfig(**TINY, use_flash_attention=False)
    tokens = torch.randint(0, TINY["vocab_size"], (2, 16),
                           generator=torch.Generator().manual_seed(0))
    logits = tgpt.forward(models[3], tokens, cfg)
    assert logits.shape == (2, 16, TINY["vocab_size"])
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("act", ["none", "relu", "sigmoid"])
def test_dense_blocks_match_jax(act):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((16, 24), (24, 8))]
    bs = [rng.standard_normal(n).astype(np.float32) for n in (24, 8)]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jw, tw = [jnp.asarray(w) for w in ws], [torch.from_numpy(w) for w in ws]
    jb, tb = [jnp.asarray(b) for b in bs], [torch.from_numpy(b) for b in bs]
    pairs = [
        (jdense.fused_dense(jx, jw[0], jb[0]), tdense.fused_dense(tx, tw[0], tb[0])),
        (jdense.fused_dense_gelu_dense(jx, jw[0], jb[0], jw[1], jb[1]),
         tdense.fused_dense_gelu_dense(tx, tw[0], tb[0], tw[1], tb[1])),
        (jdense.mlp(jx, jw, jb, act), tdense.mlp(tx, tw, tb, act)),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


# -------------------------------------------------------------- the engine


def test_engine_prefill_and_decode_logits_match_jax(engines):
    je, te = engines
    for e in engines:
        e.reset_cache()
    alloc = tinfer.PageAllocator(ECFG["num_pages"])
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5], [9, 2, 6], [7] * 17]
    tables = [alloc.alloc(tinfer.pages_for(len(p) + 3, 8)) for p in prompts]
    np.testing.assert_array_equal(te.prefill(prompts, tables),
                                  je.prefill(prompts, tables))
    lens = [len(p) for p in prompts]
    feed = [7, 11, 5]
    for _ in range(3):
        ref = je.decode_logits(feed, lens, tables)
        got = te.decode_logits(feed, lens, tables)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
        feed = ref.argmax(-1).tolist()
        lens = [n + 1 for n in lens]


def test_engine_greedy_tokens_match_jax(engines):
    je, te = engines
    for e in engines:
        e.reset_cache()
    alloc = tinfer.PageAllocator(ECFG["num_pages"])
    prompts = [[5, 9, 2, 7, 1, 3], [11, 4, 8], [1, 2]]
    tables = [alloc.alloc(tinfer.pages_for(len(p) + 8, 8)) for p in prompts]
    outs = {}
    for name, e in (("jax", je), ("torch", te)):
        toks = e.prefill(prompts, tables).tolist()
        lens = [len(p) for p in prompts]
        seq = [toks]
        for _ in range(7):
            toks = e.decode(toks, lens, tables).tolist()
            lens = [n + 1 for n in lens]
            seq.append(toks)
        outs[name] = seq
    assert outs["torch"] == outs["jax"]


def test_engine_matches_own_full_forward(models, engines):
    """Paged incremental decode against the port's own contiguous forward."""
    _, _, tcfg, tparams = models
    _, te = engines
    te.reset_cache()
    alloc = tinfer.PageAllocator(ECFG["num_pages"])
    prompt = [3, 1, 4, 1, 5]
    table = [alloc.alloc(2)]
    te.prefill([prompt], table)
    paged = te.decode_logits([7], [len(prompt)], table)
    full = tgpt.forward(tparams, torch.tensor([prompt + [7]]), tcfg)
    np.testing.assert_allclose(paged[0], full[0, -1].numpy(), atol=1e-5, rtol=0)


def test_padding_rows_cannot_perturb_live_rows(engines):
    _, te = engines
    p0, p1 = [3, 1, 4, 1], [9, 2, 6, 5]
    logits = []
    for feed, lens in (([7], [4]), ([7, 8], [4, 4])):
        te.reset_cache()
        alloc = tinfer.PageAllocator(ECFG["num_pages"])
        tables = [alloc.alloc(1), alloc.alloc(1)]
        te.prefill([p0, p1], tables)
        logits.append(te.decode_logits(feed, lens, tables[: len(feed)])[0])
    np.testing.assert_allclose(logits[0], logits[1], atol=1e-6, rtol=0)


def test_copy_pages_duplicates_every_layer(engines):
    _, te = engines
    te.reset_cache()
    te.prefill([[1, 2, 3, 4, 5, 6, 7, 8]], [[3]])
    te.copy_pages([3], [5])
    for pool in (te._cache.k, te._cache.v):
        assert torch.any(pool[:, 3] != 0)
        assert torch.equal(pool[:, 5], pool[:, 3])


# -------------------------------------------------------------- batching


SPECS = [([3, 1, 4], 6), ([1, 5], 2), ([9, 2, 6, 5, 3], 8),
         ([5, 8], 1), ([7, 7, 7], 5), ([2, 4, 6, 8], 4)]
# 5 usable pages: the batch runs out mid-decode and preempts
PREEMPT_SPECS = [([3, 1, 4], 12), ([9, 2, 6], 12), ([5, 8, 1], 10)]


@pytest.mark.parametrize("specs, num_pages", [(SPECS, 17), (PREEMPT_SPECS, 6)])
def test_continuous_batcher_matches_jax(models, specs, num_pages):
    je, te = _engines(models, num_pages=num_pages)
    results = {}
    for name, mod, e in (("jax", jinfer, je), ("torch", tinfer, te)):
        bat = mod.ContinuousBatcher(e, now_fn=lambda: 1.0)
        for r in _requests(mod, specs):
            bat.submit(r)
        fin = bat.run(max_steps=400)
        assert bat.allocator.available == num_pages - 1
        assert all(not r.pages and len(r.out) == r.max_new_tokens for r in fin)
        results[name] = ({r.rid: r.out for r in fin},
                         sum(r.preemptions for r in fin))
    assert results["torch"] == results["jax"]
    if num_pages == 6:
        assert results["torch"][1] >= 1


def test_static_batching_matches_continuous(engines):
    _, te = engines
    te.reset_cache()
    bat = tinfer.ContinuousBatcher(te, now_fn=lambda: 1.0)
    for r in _requests(tinfer, SPECS):
        bat.submit(r)
    cont = {r.rid: r.out for r in bat.run(max_steps=200)}
    te.reset_cache()
    stat = {r.rid: r.out for r in tinfer.static_batched_generate(
        te, _requests(tinfer, SPECS), now_fn=lambda: 1.0)}
    assert cont == stat


@pytest.mark.parametrize("req", [
    dict(prompt=[1] * 30, max_new_tokens=10), dict(prompt=[1], max_new_tokens=0)])
def test_submit_validation(engines, req):
    with pytest.raises(ValueError):
        tinfer.ContinuousBatcher(engines[1]).submit(tinfer.Request(rid=0, **req))


def test_prefix_cache_not_ported(engines):
    with pytest.raises(NotImplementedError):
        tinfer.ContinuousBatcher(engines[1], prefix_cache=True)


# ------------------------------------------------------- host-side pieces


@pytest.mark.parametrize("n, ps", [(1, 8), (8, 8), (9, 8), (0, 8), (33, 16)])
def test_pages_for_matches_jax(n, ps):
    assert tinfer.pages_for(n, ps) == jinfer.pages_for(n, ps)


@pytest.mark.parametrize("n, buckets", [(1, (2, 4)), (3, (2, 4)), (4, (2, 4)),
                                        (5, (2, 4))])
def test_pick_bucket_matches_jax(n, buckets):
    try:
        want = jinfer.pick_bucket(n, buckets)
    except ValueError:
        with pytest.raises(ValueError):
            tinfer.pick_bucket(n, buckets)
        return
    assert tinfer.pick_bucket(n, buckets) == want


@pytest.mark.parametrize("kw", [
    dict(max_seq_len=32, page_size=8, prefill_seq_buckets=(12,)),
    dict(max_seq_len=30, page_size=8, prefill_seq_buckets=(8,)),
    dict(max_seq_len=32, page_size=8, batch_buckets=(4, 2),
         prefill_seq_buckets=(8,)),
    dict(max_seq_len=16, page_size=8, prefill_seq_buckets=(8, 32)),
])
def test_engine_config_validation(kw):
    with pytest.raises(ValueError):
        jinfer.EngineConfig(**kw)
    with pytest.raises(ValueError):
        tinfer.EngineConfig(**kw)


def test_engine_config_budget_matches_jax():
    kw = dict(max_seq_len=64, page_size=8, batch_buckets=(2, 4, 8),
              prefill_seq_buckets=(16, 32, 64), decode_batch_buckets=(4, 16))
    j, t = jinfer.EngineConfig(**kw), tinfer.EngineConfig(**kw)
    for name in ("n_slots", "max_batch", "max_prefill_batch",
                 "declared_signatures", "declared_decode_signatures"):
        assert getattr(t, name) == getattr(j, name)


def test_page_allocator_all_or_nothing_and_free():
    alloc = tinfer.PageAllocator(6)
    got = alloc.alloc(3)
    assert got is not None and len(got) == 3 and 0 not in got
    assert alloc.alloc(3) is None and alloc.available == 2
    alloc.ref(got[:1])
    alloc.free(got)
    assert alloc.available == 4 and alloc.refcount(got[0]) == 1
    alloc.free(got[:1])
    assert alloc.available == 5 and alloc.live_pages == 0
    with pytest.raises(ValueError):  # double free
        alloc.free(got)
    with pytest.raises(ValueError):  # foreign page (the null page)
        alloc.free([0])
    with pytest.raises(ValueError):  # ref on a free page
        alloc.ref([got[0]])


def test_kvcache_ops_match_jax():
    rng = np.random.default_rng(0)
    pages = rng.standard_normal((6, 4, 3)).astype(np.float32)
    table = np.array([[2, 5, 0], [1, 0, 0]], np.int32)
    vals = rng.standard_normal((2, 8, 3)).astype(np.float32)
    tok = rng.standard_normal((2, 3)).astype(np.float32)
    pos = np.array([6, 2], np.int32)
    j = jinfer.write_prefill(jnp.asarray(pages), jnp.asarray(table),
                             jnp.asarray(vals))
    j = jinfer.write_token(j, jnp.asarray(table), jnp.asarray(pos),
                           jnp.asarray(tok))
    t = torch.from_numpy(pages.copy())
    tinfer.write_prefill(t, torch.from_numpy(table), torch.from_numpy(vals))
    tinfer.write_token(t, torch.from_numpy(table), torch.from_numpy(pos),
                       torch.from_numpy(tok))
    # page 0 took colliding padding writes: its content is unspecified
    np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])
    np.testing.assert_array_equal(
        tinfer.gather_pages(t, torch.from_numpy(table)).numpy()[0, :8],
        np.asarray(jinfer.gather_pages(j, jnp.asarray(table)))[0, :8])


@pytest.mark.parametrize("shapes", [[(2, 3, 4, 8)] * 2, [(5,), (7, 3)], [(0,)]])
def test_arena_spec_matches_jax(shapes):
    want = jarena.make_spec([jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
    got = tarena.make_spec(shapes)
    assert (got.offsets, got.total, got.padded_total) == (
        want.offsets, want.total, want.padded_total)
    flat = torch.arange(got.padded_total, dtype=torch.float32)
    views = tarena.unflatten(flat, got)
    assert [tuple(v.shape) for v in views] == [tuple(s) for s in shapes]
    if views[0].numel():
        views[0].fill_(-1.0)  # views alias the arena
        assert flat[0] == -1.0


def test_alloc_cache_is_one_zeroed_arena():
    layout = tinfer.PagedLayout(n_layers=2, n_pages=3, page_size=4, kv_dim=8)
    cache = tinfer.alloc_cache(layout, "cpu")
    assert cache.k.shape == cache.v.shape == (2, 3, 4, 8)
    assert cache.flat.numel() == tarena.TILE and not torch.any(cache.flat)
    cache.v[1, 2, 3, 7] = 1.0
    assert cache.flat[2 * 2 * 3 * 4 * 8 - 1] == 1.0


def test_cast_floats_leaves_integers():
    tree = {"a": torch.zeros(2), "b": [torch.zeros(2, dtype=torch.int32), 3]}
    out = cast_floats(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int32 and out["b"][1] == 3


# ------------------------------------------------------------ the gate


def test_track_compiles_strict_gate_unit():
    gated = track_compiles("gate_unit", strict=True, max_signatures=1)(
        lambda x: x + 1)
    gated(torch.zeros(2))
    with pytest.raises(BucketGateError):
        gated(torch.zeros(3))
    gated(torch.zeros(2))  # a declared signature keeps working
    with pytest.raises(BucketGateError):  # the refused one was not registered
        gated(torch.zeros(3))
    assert gated.calls == 4 and len(gated.signatures) == 1


def test_track_compiles_lenient_warns_once():
    gated = track_compiles("gate_lenient")(lambda x: x)
    gated(torch.zeros(2))
    with pytest.warns(UserWarning, match="second signature"):
        gated(torch.zeros(3))
    gated(torch.zeros(4))  # counted, not warned again
    assert len(gated.signatures) == 3 and gated.calls == 3


def test_track_compiles_strict_requires_budget():
    with pytest.raises(ValueError):
        track_compiles("gate_nobudget", strict=True)


def test_engine_gate_rejects_undeclared_signature(models):
    _, _, tcfg, tparams = models
    ecfg = tinfer.EngineConfig(max_seq_len=16, page_size=8, num_pages=9,
                               batch_buckets=(2,), prefill_seq_buckets=(8,))
    eng = tinfer.InferenceEngine(tparams, tcfg, ecfg, device="cpu")
    alloc = tinfer.PageAllocator(ecfg.num_pages)
    tables = [alloc.alloc(1), alloc.alloc(1)]
    toks = eng.prefill([[1, 2, 3], [4, 5]], tables)
    assert eng.compiled_signatures == 1
    with pytest.raises(ValueError):  # host API: batch 3 > largest bucket
        eng.prefill([[1], [2], [3]], [[1], [2], [3]])
    eng.decode(toks.tolist(), [3, 2], tables)
    assert eng.compiled_signatures == 2
    z = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(BucketGateError):
        eng._decode_gated(z, z, torch.zeros((3, ecfg.n_slots), dtype=torch.int64))
    eng.decode(toks.tolist(), [4, 3], tables)
    assert eng.compiled_signatures <= ecfg.declared_signatures
    assert eng.call_counts == {"prefill": 1, "decode": 3, "copy": 0}


# ------------------------------------------------ import and device rules


PORT_FILES = sorted(
    p.relative_to(REPO).as_posix()
    for p in [*(REPO / "beforeholiday_tpu_torch").rglob("*.py"),
              REPO / "chip_smoke.py"]
)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "beforeholiday_tpu"}


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_never_imports_jax_or_the_jax_package(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_entry_points_raise_without_a_card(models, monkeypatch):
    _, _, tcfg, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tinfer.InferenceEngine(tparams, tcfg, tinfer.EngineConfig(**ECFG))
    with pytest.raises(RuntimeError):
        tgpt.init(tcfg, torch.Generator())
    with pytest.raises(RuntimeError):
        tgpt.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError):
        tinfer.InferenceEngine(tparams, tcfg, tinfer.EngineConfig(**ECFG),
                               device="cuda")
    with pytest.raises(RuntimeError):
        LossScaler().init()
    with pytest.raises(RuntimeError):
        tgpt.synthetic_batch(tcfg, 2, generator=torch.Generator())
    with pytest.raises(RuntimeError):
        tgpt.state_from_numpy({"step": np.zeros((), np.int32)})
