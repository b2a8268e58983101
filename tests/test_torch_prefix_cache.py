"""Port parity: the radix prefix cache (``infer/radix.py``) and
``ContinuousBatcher(prefix_cache=True)`` held against the JAX package, on
the CPU.

``RadixCache`` keeps the laws of the JAX package's ``TestRadixCache``, and a
seeded stream of inserts, lookups, frees and evictions leaves both packages
with the same pages, refcounts and counters. The batcher runs the same
request mix in both packages with the same weights and a fake clock, on
fp32 and e4m3 pages, and after every ``step()`` the two agree on every
request's stream, page list and cached length, on every page's refcount and
on the tree's ``hit_rate`` and ``pages_held``: decode-extend, the
whole-prompt copy on write, radix eviction under page famine and replays
after preemption included.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from beforeholiday_tpu import infer as jinfer
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import infer as tinfer
from beforeholiday_tpu_torch.testing import gpt as tgpt

TINY = dict(vocab_size=64, seq_len=64, d_model=32, n_heads=2, n_layers=2)
RADIX_ECFG = dict(max_seq_len=32, page_size=4, batch_buckets=(2, 4),
                  prefill_seq_buckets=(8, 16, 32))
SHARED = [7, 7, 3, 9, 1, 2, 4, 8]  # two full pages at page_size 4
_PREFIX = itertools.count()
PACKAGES = {"jax": jinfer, "torch": tinfer}


# ------------------------------------------------------------- radix laws


def _mk(mod, n_pages=10, ps=4):
    a = mod.PageAllocator(n_pages)
    return a, mod.RadixCache(a, ps)


def _law_insert_then_lookup(mod):
    a, rc = _mk(mod)
    pages = a.alloc(2)
    adopted = rc.insert([1, 2, 3, 4, 5, 6, 7, 8, 9], pages)  # 2 full pages
    assert adopted == 2 and rc.pages_held == 2
    assert all(a.refcount(p) == 2 for p in pages)  # owner + tree
    hit, m = rc.lookup([1, 2, 3, 4, 5, 6, 7, 8, 42])
    assert hit == pages and m == 8
    assert all(a.refcount(p) == 3 for p in pages)  # + the lookup
    a.free(hit)
    return hit, m, rc.hit_rate


def _law_partial_and_miss(mod):
    a, rc = _mk(mod)
    pages = a.alloc(2)
    rc.insert([1, 2, 3, 4, 5, 6, 7, 8], pages)
    hit, m = rc.lookup([1, 2, 3, 4, 9, 9, 9, 9])  # diverges at page 2
    assert hit == pages[:1] and m == 4
    a.free(hit)
    assert rc.lookup([9, 9, 9, 9]) == ([], 0)
    assert rc.lookup([1, 2, 3]) == ([], 0)  # shorter than a page
    assert 0.0 < rc.hit_rate < 1.0
    return rc.hit_rate, rc.lookup_tokens, rc.hit_tokens


def _law_insert_keeps_existing(mod):
    a, rc = _mk(mod)
    first = a.alloc(2)
    rc.insert([1, 2, 3, 4, 5, 6, 7, 8], first)
    second = a.alloc(2)
    adopted = rc.insert([1, 2, 3, 4, 9, 9, 9, 9], second)
    assert adopted == 1  # only the diverging page-2 chunk
    hit, _ = rc.lookup([1, 2, 3, 4])
    assert hit == first[:1]  # the resident page, not second[0]
    a.free(hit)
    assert a.refcount(second[0]) == 1  # the tree never took it
    return adopted, hit


def _law_evict_lru_leaf_only(mod):
    a, rc = _mk(mod, n_pages=12)
    deep = a.alloc(2)
    rc.insert([1, 2, 3, 4, 5, 6, 7, 8], deep)  # parent + child
    solo = a.alloc(1)
    rc.insert([7, 7, 7, 7], solo)
    a.free(deep + solo)  # owners drop out; the tree's refs keep pages live
    hit, _ = rc.lookup([1, 2, 3, 4, 5, 6, 7, 8])  # a reader pins the child
    assert rc.evict(1) == 1  # the older leaf, solo; never the parent
    assert a.refcount(solo[0]) == 0
    assert rc.evict(1) == 1  # now the deep child leaf
    assert a.refcount(deep[1]) == 1  # the reader still holds it
    assert rc.pages_held == 1  # the parent, now a leaf
    a.free(hit)
    return a.available, rc.pages_held


def _law_clear(mod):
    a, rc = _mk(mod)
    pages = a.alloc(3)
    rc.insert(list(range(1, 13)), pages)
    a.free(pages)
    assert a.available == 9 - 3
    assert rc.clear() == 3
    assert a.available == 9 and rc.pages_held == 0
    return a.available


@pytest.mark.parametrize("law", [
    _law_insert_then_lookup, _law_partial_and_miss, _law_insert_keeps_existing,
    _law_evict_lru_leaf_only, _law_clear], ids=lambda f: f.__name__[5:])
def test_radix_laws_match_jax(law):
    assert law(tinfer) == law(jinfer)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_random_ops_match_jax(seed):
    """A seeded stream of inserts (owner pages freshly allocated), lookups
    (their refs kept or dropped), evictions and owner frees: after every op
    both packages hold the same refcounts, free count and counters."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(120):
        kind = rng.choice(["insert", "lookup", "evict", "free"], p=[.35, .35, .15, .15])
        prefix = rng.integers(0, 3)
        tokens = [int(prefix)] * 4 + rng.integers(0, 3, rng.integers(0, 13)).tolist()
        ops.append((str(kind), tokens, int(rng.integers(1, 4)), bool(rng.integers(2))))
    trails = {}
    for name, mod in PACKAGES.items():
        a, rc = _mk(mod, n_pages=24)
        held, trail = [], []
        for kind, tokens, n, keep in ops:
            if kind == "insert":
                pages = a.alloc(-(-len(tokens) // 4))
                if pages is not None:
                    out = rc.insert(tokens, pages)
                    held.append(pages)
                else:
                    out = None
            elif kind == "lookup":
                out = rc.lookup(tokens)
                (held.append if keep else a.free)(out[0])
            elif kind == "evict":
                out = rc.evict(n)
            else:
                out = held.pop(0) if held else None
                if out is not None:
                    a.free(out)
            trail.append((out, a.available, rc.pages_held, rc.hit_rate,
                          tuple(a.refcount(p) for p in range(24))))
        for pages in held:
            a.free(pages)
        trail.append((rc.clear(), a.available))
        trails[name] = trail
    assert trails["torch"] == trails["jax"]
    assert trails["torch"][-1][1] == 23  # every page back in the pool


# ------------------------------------------------- the batcher, step by step


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tgpt.GPTConfig(**TINY)
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


_ENGINES = {}


def _engines(models, **kw):
    """One engine a package for this configuration, built once a module (the
    JAX engine under its own entry prefix: its signature gate counts per
    entry name across the process)."""
    key = tuple(sorted(kw.items()))
    if key not in _ENGINES:
        jcfg, jparams, tcfg, tparams = models
        je = jinfer.InferenceEngine(jparams, jcfg, jinfer.EngineConfig(
            **kw, entry_prefix=f"torch_radix_{next(_PREFIX)}"))
        te = tinfer.InferenceEngine(tparams, tcfg, tinfer.EngineConfig(**kw),
                                    device="cpu")
        _ENGINES[key] = (je, te)
    return _ENGINES[key]


def _family(mod, n, shared=SHARED):
    """Requests sharing ``shared``'s two full pages, with 0-2 token tails
    (the JAX tests' ``_family``)."""
    reqs = []
    for i in range(n):
        tail = [(i * 3 + j) % 60 for j in range(i % 3)]
        reqs.append(mod.Request(rid=i, prompt=list(shared) + tail,
                                max_new_tokens=4 + i % 3))
    return reqs


def _state(bat):
    """Everything the scheduler decided, as plain values."""
    reqs = (list(bat.active) + list(bat.waiting) + list(bat.finished)
            + list(getattr(bat, "handoff", ())))
    out = {
        "active": [r.rid for r in bat.active],
        "waiting": [r.rid for r in bat.waiting],
        "finished": [r.rid for r in bat.finished],
        "handoff": [r.rid for r in getattr(bat, "handoff", ())],
        "requests": {r.rid: (list(r.out), list(r.pages), r.cached, r.preemptions)
                     for r in reqs},
        "refs": [bat.allocator.refcount(p) for p in range(bat.allocator.n_pages)],
        "available": bat.allocator.available,
    }
    if bat.radix is not None:
        out["radix"] = (bat.radix.hit_rate, bat.radix.pages_held,
                        bat.radix.lookup_tokens, bat.radix.hit_tokens)
    return out


def _lockstep(engines, make_requests, batcher="ContinuousBatcher", steps=400,
              submit_later=(), **kw):
    """Both packages' batchers over the same requests, one ``step()`` at a
    time, their states equal after each; ``submit_later`` requests join once
    the first ones have finished. Returns the torch batcher and the trail of
    states."""
    bats = {}
    for (name, mod), eng in zip(PACKAGES.items(), engines):
        eng.reset_cache()
        bats[name] = getattr(mod, batcher)(eng, now_fn=lambda: 1.0, **kw)
        for r in make_requests(mod):
            bats[name].submit(r)
    trail, later = [], list(submit_later)
    for _ in range(steps):
        if bats["torch"].idle:
            if not later:
                break
            for name, mod in PACKAGES.items():
                for r in later[0](mod):
                    bats[name].submit(r)
            later.pop(0)
        done = {name: sorted(r.rid for r in b.step()) for name, b in bats.items()}
        states = {name: _state(b) for name, b in bats.items()}
        assert done["torch"] == done["jax"]
        assert states["torch"] == states["jax"], f"step {len(trail)}"
        trail.append(states["torch"])
    assert bats["torch"].idle and bats["jax"].idle
    return bats["torch"], trail


@pytest.mark.parametrize("cache_dtype", ["float32", "e4m3"])
def test_prefix_cache_lockstep_matches_jax(models, cache_dtype):
    """A shared-prefix family and a second wave repeating whole prompts:
    decode-extend, the copy-on-write tail and refcounts in lockstep with
    JAX; every request finishes; after ``radix.clear()`` the pool is whole."""
    engines = _engines(models, **RADIX_ECFG, num_pages=33, cache_dtype=cache_dtype)
    repeat = lambda mod: [mod.Request(rid=10 + i, prompt=list(SHARED) + [5] * i,
                                      max_new_tokens=3) for i in (0, 4)]
    copies = engines[1].call_counts["copy"]
    bat, trail = _lockstep(engines, lambda mod: _family(mod, 6),
                           submit_later=[repeat], prefix_cache=True)
    assert len(bat.finished) == 8 and bat.radix.hit_tokens > 0
    # the whole-prompt repeat (rid 10) was admitted with only its last token
    # to re-run, on a copy of its tail page: one decode tick gave its first
    # token at the prompt's length
    first = next(s["requests"][10] for s in trail if 10 in s["requests"])
    assert first[0] and len(first[0]) == 1 and first[2] == len(SHARED)
    assert engines[1].call_counts["copy"] > copies
    assert all(bat.allocator.refcount(p) == (1 if bat.radix.pages_held else 0)
               for p in range(1, bat.allocator.n_pages)
               if bat.allocator.refcount(p))
    bat.radix.clear()
    assert bat.allocator.available == bat.allocator.n_pages - 1
    assert all(bat.allocator.refcount(p) == 0 for p in range(bat.allocator.n_pages))


def test_prefix_cache_eviction_and_replays_match_jax(models):
    """A pool of 9 usable pages: famine evicts tree leaves before it
    preempts, preempted requests replay through a full prefill, and the two
    packages stay in lockstep; the radix tree gave pages back."""
    engines = _engines(models, **RADIX_ECFG, num_pages=10)
    specs = [([3, 1, 4, 2], 10), ([3, 1, 4, 2], 10), ([5, 8, 1, 9], 8),
             ([3, 1, 4, 2, 6, 6, 6, 6], 6), ([5, 8, 1, 9, 2], 9)]
    reqs = lambda mod: [mod.Request(rid=i, prompt=list(p), max_new_tokens=n)
                        for i, (p, n) in enumerate(specs)]
    bat, trail = _lockstep(engines, reqs, prefix_cache=True)
    held = [s["radix"][1] for s in trail]
    assert any(b < a for a, b in zip(held, held[1:])), "no radix eviction"
    assert sum(r.preemptions for r in bat.finished) > 0
    assert {r.rid: len(r.out) for r in bat.finished} == {
        i: n for i, (_, n) in enumerate(specs)}


def test_prefix_cache_streams_equal_uncached_run(models):
    """In fp32 on the CPU, decode-extend writes the same K/V a prefill
    would: the cached run's streams equal the uncached run's."""
    _, te = _engines(models, **RADIX_ECFG, num_pages=33)
    outs = []
    for on in (False, True):
        te.reset_cache()
        bat = tinfer.ContinuousBatcher(te, now_fn=lambda: 1.0, prefix_cache=on)
        for r in _family(tinfer, 6):
            bat.submit(r)
        outs.append({r.rid: r.out for r in bat.run(max_steps=300)})
    assert outs[0] == outs[1]


# ---------------------------------------------------------- disaggregation


SPECS = [([3, 1, 4], 6), ([1, 5], 2), ([9, 2, 6, 5, 3], 8),
         ([5, 8], 1), ([7, 7, 7], 5), ([2, 4, 6, 8], 4)]


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_disaggregated_lockstep_matches_jax(models, prefix_cache):
    """``DisaggregatedBatcher`` (prefill buckets (2, 4), decode bucket 4)
    in lockstep with JAX's, alone on a mixed workload and with the prefix
    cache on a shared-prefix family: the active set and handoff queue,
    streams, pages and refcounts after every step; the engine inside its
    declared signatures."""
    kw = dict(max_seq_len=32, page_size=4 if prefix_cache else 8, num_pages=33,
              batch_buckets=(2, 4), prefill_seq_buckets=(8, 16, 32),
              decode_batch_buckets=(4,))
    engines = _engines(models, **kw)
    if prefix_cache:
        reqs = lambda mod: _family(mod, 6)
    else:
        reqs = lambda mod: [mod.Request(rid=i, prompt=list(p), max_new_tokens=n)
                            for i, (p, n) in enumerate(SPECS)]
    bat, trail = _lockstep(engines, reqs, batcher="DisaggregatedBatcher",
                           prefix_cache=prefix_cache)
    assert len(bat.finished) == 6
    assert all(len(s["active"]) <= 4 for s in trail)  # decode capacity
    assert engines[1].compiled_signatures <= engines[1].cfg.declared_signatures
    if prefix_cache:
        assert bat.radix.hit_tokens > 0
        bat.radix.clear()
    assert bat.allocator.available == bat.allocator.n_pages - 1


def test_disaggregated_streams_equal_unified(models):
    """The split bucket sets change nothing a request sees: the unified
    batcher's streams on the same weights."""
    _, dis = _engines(models, max_seq_len=32, page_size=8, num_pages=33,
                      batch_buckets=(2, 8), prefill_seq_buckets=(8, 16, 32),
                      decode_batch_buckets=(8,))
    uni = tinfer.InferenceEngine(dis._params, dis.model_cfg, tinfer.EngineConfig(
        max_seq_len=32, page_size=8, num_pages=33, batch_buckets=(8,),
        prefill_seq_buckets=(8, 16, 32)), device="cpu")
    outs = []
    for cls, eng in ((tinfer.ContinuousBatcher, uni),
                     (tinfer.DisaggregatedBatcher, dis)):
        eng.reset_cache()
        bat = cls(eng, now_fn=lambda: 1.0)
        for i, (p, n) in enumerate(SPECS):
            bat.submit(tinfer.Request(rid=i, prompt=list(p), max_new_tokens=n))
        outs.append({r.rid: r.out for r in bat.run(max_steps=300)})
    assert outs[0] == outs[1]
