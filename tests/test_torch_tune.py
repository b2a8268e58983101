"""Port parity: the autotuner (``beforeholiday_tpu_torch/tune``) against the
JAX package's ``beforeholiday_tpu/tune``, in one process.

* ``shipped_space()`` knob for knob (names, values, defaults, layers,
  ``requires``, ``requires_context``); ``violations``, ``sanitize`` and
  ``single_knob_configs`` on seeded random configs and contexts;
* manifest files written by either package read by the other, and a
  corrupt or wrong-schema file degrading to empty in both;
* ``tune()`` with one deterministic costed ``trial_fn`` (per-step costs by
  config, compute-bound evidence booked to each package's roofline ledger,
  memory evidence stubbed per config) giving the same winner, trial count,
  records (configs, horizons, entries, prune reasons) and stored entry as
  JAX's; a second run on the same key is a cache hit with 0 trials;
* ``resolve_knobs`` equal to JAX's for hit, miss (one warning a site) and
  explicit cases; ``amp.initialize(tuned=True)``, DDP, ZeRO-2 and
  ``ZeRO3FusedAdam(tuned=True)`` resolving as JAX's do;
* the port's key: stable, and moved by a leaf shape, a mesh and a chip. The
  port's digests are its own (a JAX-written entry does not hit), so each
  package is keyed here by the digest string both manifests share.
"""

import logging
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import tune as jtune
from beforeholiday_tpu.utils.logging import reset_warn_once as jreset_warn_once
from beforeholiday_tpu_torch import tune
from beforeholiday_tpu_torch.tune import search, space
from beforeholiday_tpu_torch.utils.logging import reset_warn_once

MiB = 1 << 20
KEY = "0123456789abcdef"  # a digest string both manifests take


def _knob(k):
    return (k.name, k.values, k.default, k.layer, k.requires, k.requires_context)


def test_shipped_space_equals_jax():
    ours, ref = tune.shipped_space(), jtune.shipped_space()
    assert ours.names() == ref.names()
    assert [_knob(ours[n]) for n in ours.names()] == [_knob(ref[n]) for n in ref.names()]
    assert ours.defaults() == ref.defaults()
    assert tune.UNSET is space.UNSET and repr(tune.UNSET) == "UNSET"
    assert not tune.UNSET


def _random_case(rng, sp):
    """A config of random knobs (some illegal values, an unknown knob now
    and then) and a random context."""
    cfg = {}
    for name in rng.sample(sp.names(), rng.randint(0, len(sp))):
        vals = list(sp[name].values)
        cfg[name] = rng.choice(vals + ["bogus"] if rng.random() < 0.1 else vals)
    if rng.random() < 0.1:
        cfg["not_a_knob"] = 1
    ctx = {f: rng.random() < 0.5 for f in ("two_level", "sequence_parallel")}
    return cfg, ctx


@pytest.mark.parametrize("seed", range(3))
def test_space_logic_equals_jax_on_random_configs(seed):
    ours, ref = tune.shipped_space(), jtune.shipped_space()
    rng = random.Random(seed)
    for _ in range(150):
        cfg, ctx = _random_case(rng, ours)
        assert ours.violations(cfg, ctx) == ref.violations(cfg, ctx)
        assert ours.is_legal(cfg, ctx) == ref.is_legal(cfg, ctx)
        base = {n: ours[n].default for n in rng.sample(ours.names(), 4)}
        for b in (None, base):
            assert ours.sanitize(cfg, context=ctx, base=b) == \
                ref.sanitize(cfg, context=ctx, base=b)
        assert ours.single_knob_configs(ctx) == ref.single_knob_configs(ctx)
    with pytest.raises(tune.KnobConstraintError):
        ours.validate({"bucket_bytes_dcn": 4 * MiB})


def test_manifest_files_round_trip_between_packages(tmp_path):
    path = str(tmp_path / "m.json")
    ours = tune.TuningManifest(path)
    ours.store(KEY, {"opt_level": "O6", "prefetch": 2}, cost_s=0.0125, trials=5)
    back = jtune.TuningManifest(path).lookup(KEY)
    assert back == ours.lookup(KEY)
    assert back["config"] == {"opt_level": "O6", "prefetch": 2}
    jpath = str(tmp_path / "j.json")
    jtune.TuningManifest(jpath).store("fedcba9876543210", {"remat_policy": "full"},
                                      cost_s=0.5, trials=3)
    assert tune.TuningManifest(jpath).lookup("fedcba9876543210") == \
        jtune.TuningManifest(jpath).lookup("fedcba9876543210")
    # the same entry stored by each package: byte-identical files
    jtune.TuningManifest(jpath + "2").store(KEY, {"opt_level": "O6", "prefetch": 2},
                                            cost_s=0.0125, trials=5)
    with open(path, "rb") as f, open(jpath + "2", "rb") as g:
        assert f.read() == g.read()
    for bad in ("{not json", '{"schema": "other", "entries": {}}'):
        with open(path, "w") as f:
            f.write(bad)
        assert len(tune.TuningManifest(path)) == 0 == len(jtune.TuningManifest(path))
    assert tune.SCHEMA == jtune.SCHEMA


# ---- the search ---------------------------------------------------------


SUBSET = ("opt_level", "remat_policy", "prefetch", "compress")


class _CostedTrials:
    """Deterministic ``trial_fn``: per-step cost by config, linear in steps;
    books compute-bound (or memory-bound) roofline evidence for the entry
    in its package's ledger."""

    def __init__(self, record_wall_time, costs, compute):
        self.record_wall_time = record_wall_time
        self.costs, self.compute = costs, compute
        self.calls = []

    def __call__(self, config, steps, entry):
        key = tuple(sorted(config.items()))
        self.calls.append((dict(config), steps, entry))
        intensity = 1e6 if key in self.compute else 1e-3
        self.record_wall_time(entry, 0.0, steps=1, flops=intensity,
                              bytes_accessed=1.0)
        return self.costs[key] * steps


def _plan(sp):
    """Per-step costs over the candidate set: a fixed pseudo-random order,
    every third config compute-bound, two configs over the memory budget."""
    cands = [sp.defaults()] + [c for _, _, c in sp.single_knob_configs()]
    rng = random.Random(7)
    costs, compute, hungry = {}, set(), set()
    for i, cfg in enumerate(cands):
        k = tuple(sorted(cfg.items()))
        costs[k] = 0.01 + 0.001 * rng.randrange(40)
        if i % 3 == 2:
            compute.add(k)
        if i in (4, 7):
            hungry.add(k)
    return costs, compute, hungry


def _run_tune(pkg, search_mod, monkeypatch, manifest, hungry, costs, compute):
    from beforeholiday_tpu import monitor as jmonitor
    from beforeholiday_tpu_torch import monitor

    mon = monitor if pkg is tune else jmonitor
    mon.reset_roofline_ledger()

    def peak(entry):  # the memory ledger's reading, stubbed per config
        cfg = trials.calls[-1][0]
        return 1 << 40 if tuple(sorted(cfg.items())) in hungry else 1 << 20

    monkeypatch.setattr(search_mod, "_entry_peak_temp_bytes", peak)
    trials = _CostedTrials(mon.record_wall_time, costs, compute)
    sp = pkg.shipped_space().subset(SUBSET)
    res = pkg.tune(trials, sp, KEY, manifest=manifest, max_trials=9,
                   steps_per_trial=2, iters=2, memory_budget_bytes=1 << 30)
    return res, trials


def test_tune_matches_jax(tmp_path, monkeypatch):
    from beforeholiday_tpu.tune import search as jsearch

    costs, compute, hungry = _plan(tune.shipped_space().subset(SUBSET))
    got, calls = _run_tune(tune, search, monkeypatch, str(tmp_path / "p.json"),
                           hungry, costs, compute)
    ref, jcalls = _run_tune(jtune, jsearch, monkeypatch, str(tmp_path / "j.json"),
                            hungry, costs, compute)
    assert got.config == ref.config and got.trials == ref.trials == 9
    assert got.cost_s == ref.cost_s and not got.cache_hit
    rows = lambda r: [(x.config, x.steps, x.entry, x.pruned, x.cost_s,
                       x.evidence.get("bound")) for x in r.records]
    assert rows(got) == rows(ref)
    reasons = {x.pruned for x in got.records}
    assert {"peak_temp_bytes_over_budget", "compute_bound_and_slower"} <= reasons
    assert calls.calls == jcalls.calls
    assert tune.TuningManifest(str(tmp_path / "p.json")).lookup(KEY) == \
        jtune.TuningManifest(str(tmp_path / "j.json")).lookup(KEY)
    # the same key again: a cache hit, zero trials, trial_fn never called
    n = len(calls.calls)
    again = tune.tune(calls, tune.shipped_space().subset(SUBSET), KEY,
                      manifest=str(tmp_path / "p.json"), max_trials=9)
    assert again.cache_hit and again.trials == 0 and again.records == []
    assert again.config == got.config and len(calls.calls) == n


def test_trial_scope_resets_only_its_own_entry():
    from beforeholiday_tpu_torch.monitor import compile as mcompile

    mcompile.reset_compile_counts()
    fa = mcompile.track_compiles("tune.trial0")(lambda x: x + 1)
    fb = mcompile.track_compiles("other")(lambda x: x + 1)
    fa(torch.zeros(2)), fb(torch.zeros(2))
    with tune.trial_scope("tune.trial0") as entry:
        assert entry == "tune.trial0"
    counts = mcompile.compile_counts()
    assert counts.get("tune.trial0", {}).get("calls", 0) == 0
    assert counts["other"]["calls"] == 1
    mcompile.reset_compile_counts()


# ---- resolution -----------------------------------------------------------


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _resolve_both(tmp_path, stored, kind, defaults, explicit, context=None):
    out = []
    for pkg, name in ((tune, "p"), (jtune, "j")):
        path = str(tmp_path / f"{name}-{kind}.json")
        if stored is not None:
            pkg.TuningManifest(path).store(KEY, stored)
        out.append(pkg.resolve_knobs(kind, defaults, {
            k: (pkg.UNSET if v is tune.UNSET else v) for k, v in explicit.items()},
            tuned=True, key=KEY, manifest=path, context=context))
    return out


@pytest.mark.parametrize("case", ["hit", "explicit", "stale", "miss", "untuned"])
def test_resolve_knobs_equals_jax(tmp_path, case):
    defaults = {"compress": False, "bucket_bytes": None, "hierarchical": False}
    stored = {"compress": True, "bucket_bytes": 4 * MiB, "hierarchical": True}
    explicit = {"compress": tune.UNSET, "bucket_bytes": tune.UNSET,
                "hierarchical": tune.UNSET}
    ctx = {"two_level": True}
    if case == "explicit":
        explicit["compress"] = False  # restating the default still wins
    if case == "stale":
        ctx = {"two_level": False}
    if case == "untuned":
        got = tune.resolve_knobs("site", defaults, {"compress": True})
        ref = jtune.resolve_knobs("site", defaults, {"compress": True})
        assert got == ref == ({**defaults, "compress": True}, "explicit")
        return
    reset_warn_once(("tune.resolve", "site"))
    jreset_warn_once(("tune.resolve", "site"))
    h = _Capture()
    logging.getLogger("beforeholiday_tpu_torch").addHandler(h)
    try:
        got, ref = _resolve_both(tmp_path, None if case == "miss" else stored,
                                 "site", defaults, explicit, ctx)
        for _ in range(3):
            tune.resolve_knobs("site", defaults, tuned=True, key=KEY,
                               manifest=str(tmp_path / "none.json"))
    finally:
        logging.getLogger("beforeholiday_tpu_torch").removeHandler(h)
    assert got == ref
    misses = [r for r in h.records if "no manifest entry" in r.getMessage()]
    assert len(misses) == 1  # once a site, not once a call
    assert got[1] == {"miss": "defaults"}.get(case, "manifest")


def _store(pkg, path, config):
    pkg.TuningManifest(path).store(KEY, config)
    return path


def test_amp_initialize_tuned_resolves_as_jax(tmp_path):
    from beforeholiday_tpu import amp as jamp
    from beforeholiday_tpu.optimizers import FusedAdam as JFusedAdam
    from beforeholiday_tpu_torch import amp

    path = _store(tune, str(tmp_path / "m.json"), {"opt_level": "O6"})
    params = {"w": torch.zeros(4, 4)}
    jparams = {"w": jnp.zeros((4, 4), jnp.float32)}
    for level, want in ((None, "O6"), ("O5", "O5")):
        m = amp.initialize(lambda p, x: x @ p["w"], params, None, level, tuned=True,
                           tuning_key=KEY, tuning_manifest=path)
        jm = jamp.initialize(lambda p, x: x @ p["w"], jparams, JFusedAdam(lr=1e-3),
                             level, tuned=True, tuning_key=KEY, tuning_manifest=path)
        assert m.policy.opt_level == jm.policy.opt_level == want
    # the default key is the params tree's: the port's own digest
    key = tune.tuning_key(params)
    path = _store(tune, str(tmp_path / "k.json"), {"opt_level": "O6"})
    tune.TuningManifest(path).store(key, {"opt_level": "O6"})
    m = amp.initialize(lambda p, x: x @ p["w"], params, None, tuned=True,
                       tuning_manifest=path)
    assert m.policy.opt_level == "O6"
    reset_warn_once(("tune.resolve", "amp.initialize"))
    m = amp.initialize(lambda p, x: x @ p["w"], params, None, tuned=True,
                       tuning_manifest=str(tmp_path / "empty.json"))
    assert m.policy.opt_level == "O5"


def test_constructors_tuned_resolve_as_jax(tmp_path):
    from beforeholiday_tpu.optimizers import (
        DistributedFusedAdam as JZ2,
        ZeRO3FusedAdam as JZ3,
    )
    from beforeholiday_tpu.parallel import DistributedDataParallel as JDDP
    from beforeholiday_tpu_torch.optimizers import DistributedFusedAdam, ZeRO3FusedAdam
    from beforeholiday_tpu_torch.parallel import DistributedDataParallel

    path = _store(tune, str(tmp_path / "m.json"),
                  {"bucket_bytes": 4 * MiB, "prefetch": 2, "compress": True,
                   "overlap_backward": True, "hierarchical": True})
    kw = dict(tuned=True, tuning_key=KEY, tuning_manifest=path)
    fields = ("bucket_bytes", "compress", "overlap_backward", "hierarchical")
    for explicit in ({}, {"compress": False}):
        ddp, jddp = DistributedDataParallel(**explicit, **kw), JDDP(**explicit, **kw)
        assert [getattr(ddp, f) for f in fields] == [getattr(jddp, f) for f in fields]
        assert ddp.hierarchical is False  # a flat axis: the stale knob reverts
        z2 = DistributedFusedAdam(lr=1e-2, **explicit, **kw)
        jz2 = JZ2(lr=1e-2, impl="jnp", **explicit, **kw)
        assert [getattr(z2, f) for f in fields] == [getattr(jz2, f) for f in fields]
    for explicit in ({}, {"prefetch": 0}):
        z3 = ZeRO3FusedAdam(lr=1e-2, **explicit, **kw)
        jz3 = JZ3(lr=1e-2, impl="jnp", **explicit, **kw)
        assert [getattr(z3, f) for f in fields + ("prefetch",)] == \
            [getattr(jz3, f) for f in fields + ("prefetch",)]
    assert ZeRO3FusedAdam(lr=1e-2, **kw).prefetch == 2
    assert ZeRO3FusedAdam(lr=1e-2, prefetch=0, **kw).prefetch == 0
    # on a two-level axis the manifest's hierarchical=True is legal and kept
    two = ZeRO3FusedAdam(lr=1e-2, axis_name=("slice", "intra"), **kw)
    jtwo = JZ3(lr=1e-2, impl="jnp", axis_name=("slice", "intra"), **kw)
    assert two.hierarchical is True and jtwo.hierarchical is True
    assert DistributedDataParallel().bucket_bytes is None
    assert ZeRO3FusedAdam(lr=1e-2).prefetch == 1


# ---- the key ----------------------------------------------------------------


def test_tuning_key_stable_and_sensitive():
    from beforeholiday_tpu_torch.monitor.roofline import H100
    from beforeholiday_tpu_torch.ops.arena import PackedParams
    from beforeholiday_tpu_torch.testing import gpt

    tree = {"b": torch.zeros(3, dtype=torch.bfloat16), "a": [torch.zeros(2, 5)]}
    k = tune.tuning_key(tree)
    assert k == tune.tuning_key({"a": [torch.ones(2, 5)],
                                 "b": torch.ones(3, dtype=torch.bfloat16)})
    assert k.digest == tune.tuning_key(tree).digest and len(k.digest) == 16
    int(k.digest, 16)
    assert k.model == "{a:[float32[2,5]],b:bfloat16[3]}"
    moved = [tune.tuning_key({**tree, "b": torch.zeros(4, dtype=torch.bfloat16)}),
             tune.tuning_key(tree, mesh={"data": 2}),
             tune.tuning_key(tree, mesh=[("data", 4)]),
             tune.tuning_key(tree, chip=H100)]
    digests = {k.digest} | {m.digest for m in moved}
    assert len(digests) == 5
    assert tune.tuning_key(tree, chip="cpu_proxy").chip == k.chip  # no card here
    assert k.describe()["digest"] == k.digest
    packed = PackedParams.pack({"w": torch.zeros(4, 4), "n": torch.zeros(4)})
    assert tune.tuning_key(packed).model.startswith("PackedParams<")
    # a callable: the abstract outputs join the inputs (fake tensors only)
    cfg = gpt.GPTConfig(vocab_size=64, seq_len=8, d_model=32, n_heads=2, n_layers=1)
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.zeros(2, 8, dtype=torch.long)
    fk = tune.tuning_key(lambda p, t: gpt.forward(p, t, cfg), (params, tok))
    assert fk.model.endswith("out:float32[2,8,64]")
    assert fk == tune.tuning_key(lambda p, t: gpt.forward(p, t, cfg), (params, tok))
    with pytest.raises(TypeError, match="example_args"):
        tune.tuning_key(lambda p: p)
    # the port's digest is its own: JAX's key of the same tree differs
    jk = jtune.tuning_key({"a": [jnp.zeros((2, 5))],
                           "b": jnp.zeros((3,), jnp.bfloat16)})
    assert jk.digest != k.digest
    np.testing.assert_equal(len(jk.digest), len(k.digest))
