"""Port parity: the collective-traffic ledger and its wrappers
(``monitor.comms``) against the JAX package's, in a gloo world of 4
processes against ``shard_map`` over 4 of the 8 host devices.

* every wrapper (psum in fp32 and bf16, pmax, pmin, all_gather stacked and
  tiled, psum_scatter, all_to_all, the variadic psum, ``axis_index_groups``)
  on the same numpy rows: fp32 results bitwise where the sum has no order
  to differ in (max, min, gathers, exchanges) and at rtol 1e-6 otherwise;
  the records (kind, dtype, site, scope, tier, calls, bytes) equal;
* the ledger of one distributed ImageNet trainer step (tiny ResNet, O5
  arena-native with SyncBN; bucketed and compressed; the backward-time
  hooks; O0 with unsynchronized BN) against the JAX ledger after one trace
  of the same step: the same sites, kinds, dtypes, tiers, bytes and
  logical bytes. Eager PyTorch books per call and JAX per trace, so one
  step equals one trace. The port books two kinds of collective JAX's
  ledger cannot see (they never pass its wrappers): the SyncBN backward's
  all-reduce of (sum_dy, sum_dy_xmu), 8 bytes a channel, and the trainer's
  ``pmean`` of the metrics and the BN state; they are held to what they
  must be;
* the ledger of one TP 2 x PP 2 step (the toy stack of
  ``tests/test_pipeline_parallel.py`` with a column-parallel stage, 1F1B
  with embed and head stages) against one JAX trace of the same step: the
  same sites, kinds, dtypes and scopes, and the same bytes per call. JAX
  books the tick loop's body once per trace, the port once per tick: the
  port's ring records are the trace's times the tick count, and the
  stage's collectives, booked once per traced branch in JAX, are compared
  per call.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples", "imagenet"))
sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402
import main_amp as jmain  # noqa: E402

from beforeholiday_tpu.models import resnet as jres  # noqa: E402
from beforeholiday_tpu.monitor import comms as jcomms  # noqa: E402
from beforeholiday_tpu.transformer import pipeline_parallel as jpp  # noqa: E402
from beforeholiday_tpu.transformer import tensor_parallel as jtp  # noqa: E402

W = 4
_shard_map = functools.partial(jax.shard_map, check_vma=False)

# (label, opt level, trainer options)
TRAINERS = [
    ("o5_syncbn", "O5", dict(sync_bn=True)),
    ("o5_bucketed_compressed", "O5", dict(sync_bn=True, bucket_bytes=4096,
                                          compress=True)),
    ("o5_overlap", "O5", dict(sync_bn=True, bucket_bytes=4096,
                              overlap_backward=True)),
    ("o0_local_bn", "O0", dict()),
]
PORT_ONLY = ("sync_bn.backward", "trainer.metrics", "trainer.bn_state")


def _xs():
    return np.random.default_rng(0).standard_normal((W, 2 * W, 3)).astype(np.float32)


def _weights():
    p, s = jres.init(jax.random.PRNGKey(0), jres.tiny_test_config())
    return jax.tree.map(np.asarray, (p, s))


def _batch():
    return next(iter(jmain.synthetic_batches(16, 16, 10, 1, seed=7)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    weights, (images, labels) = _weights(), _batch()
    calls = [("comms_scenario", (_xs(),))]
    calls += [("trainer_ledger_scenario", (weights, level, kw, images, labels))
              for _, level, kw in TRAINERS]
    calls.append(("tp_pp_ledger_scenario", _tp_pp_data()))
    return tw.run_world(tw.batch_scenario, W, tmp_path_factory.mktemp("comms"),
                        calls)


def _jax_wrappers(xs):
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("data",))

    def f(x):
        x = x[0]
        out = {
            "psum": jcomms.psum(x, "data", site="t.psum"),
            "psum_bf16": jcomms.psum(x.astype(jnp.bfloat16), "data", site="t.psum"),
            "pmax": jcomms.pmax(x, "data", site="t.pmax"),
            "pmin": jcomms.pmin(x, "data", site="t.pmin"),
            "all_gather": jcomms.all_gather(x, "data", site="t.all_gather"),
            "all_gather_tiled": jcomms.all_gather(x, "data", site="t.all_gather",
                                                  tiled=True),
            "psum_scatter": jcomms.psum_scatter(x, "data", site="t.psum_scatter",
                                                tiled=True),
            "all_to_all": jcomms.all_to_all(x[:W], "data", 0, 0, site="t.all_to_all"),
        }
        a, b = jcomms.psum((x, 2 * x[0]), "data", site="t.variadic")
        out["variadic0"], out["variadic1"] = a, b
        with jcomms.ledger_scope("outer"):
            out["async"] = jcomms.psum(x, "data", site="t.async")
        # the port's axis_index_groups psum is held to numpy below; this
        # books the same record
        out["groups"] = jcomms.psum(x, "data", site="t.groups")
        return {k: v[None] for k, v in out.items()}

    jcomms.reset_comms_ledger()
    out = jax.jit(_shard_map(f, mesh=mesh, in_specs=P("data"),
                             out_specs=P("data")))(jnp.asarray(xs))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}, \
        jcomms.comms_records()


def test_wrappers_match_jax(world):
    xs = _xs()
    jout, jrec = _jax_wrappers(xs)
    for rank, per_rank in enumerate(world):
        out = per_rank[0][0]
        for k in ("pmax", "pmin", "all_gather", "all_gather_tiled", "all_to_all"):
            np.testing.assert_array_equal(out[k], jout[k][rank], err_msg=k)
        for k in ("psum", "async", "psum_scatter"):
            np.testing.assert_allclose(out[k], jout[k][rank], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(out["variadic"][0], jout["variadic0"][rank],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["variadic"][1], jout["variadic1"][rank],
                                   rtol=1e-6, atol=1e-6)
        # bf16 sums of four terms: one rounding each, in either order
        np.testing.assert_allclose(out["psum_bf16"], jout["psum_bf16"][rank],
                                   rtol=2 ** -6, atol=2 ** -6)
        # axis_index_groups [[0, 2], [1, 3]]: the sum over this rank's half
        np.testing.assert_allclose(out["groups"], xs[rank % 2::2].sum(0),
                                   rtol=1e-6, atol=1e-6)


def test_wrapper_records_match_jax(world):
    _, jrec = _jax_wrappers(_xs())
    rec = world[0][0][1]
    key = lambda r: (r["site"], r["kind"], r["dtype"], r["scope"])  # noqa: E731
    mine = {key(r): r for r in rec}
    theirs = {key(r): r for r in jrec}
    assert set(mine) == set(theirs)
    for k, r in theirs.items():
        for f in ("axis", "tier", "calls", "bytes", "logical_bytes"):
            assert mine[k][f] == r[f], (k, f)
    summary = {r["subsystem"]: r for r in world[0][0][2]}
    assert summary["t"]["calls"] == sum(r["calls"] for r in rec)
    assert summary["t"]["compression_ratio"] == 1.0


def _jax_step_ledger(level, kw):
    tr = jmain.build_trainer(cfg=jres.tiny_test_config(), opt_level=level,
                             global_batch=16, num_classes=10, distributed=True,
                             devices=jax.devices()[:W], **kw)
    jcomms.reset_comms_ledger()
    tr.step(*tr.shard_batch(*_batch()), 0.05)
    return jcomms.comms_records()


def _totals(rows, skip=()):
    out = {}
    for r in rows:
        if r["site"] in skip:
            continue
        k = (r["site"], r["kind"], r["dtype"], r["tier"], r["axis"])
        b, lb = out.get(k, (0, 0))
        out[k] = (b + r["bytes"], lb + r["logical_bytes"])
    return out


@pytest.mark.parametrize("index", range(len(TRAINERS)),
                         ids=[t[0] for t in TRAINERS])
def test_one_step_ledger_matches_one_jax_trace(world, index):
    label, level, kw = TRAINERS[index]
    jrec = _jax_step_ledger(level, kw)
    ranks = [per_rank[1 + index] for per_rank in world]
    assert all(_totals(r) == _totals(ranks[0]) for r in ranks)
    rec = ranks[0]
    assert _totals(rec, PORT_ONLY) == _totals(jrec)
    port_only = _totals([r for r in rec if r["site"] in PORT_ONLY])
    stats = [r for r in jrec if r["site"] == "sync_bn.stats"]
    if kw.get("sync_bn"):
        # JAX books count (4 B), sum and centred squares (4 B a channel
        # each) per BN; the backward's pair is 8 B a channel
        n_bn = sum(r["calls"] for r in stats) // 3
        want = sum(r["bytes"] for r in stats) - 4 * n_bn
        assert port_only[("sync_bn.backward", "psum", "float32", "ici", "data")] == (
            want, want)
    else:
        assert not stats
        bn_bytes = 4 * sum(a.size for a in jax.tree.leaves(_weights()[1]))
        assert port_only[("trainer.bn_state", "psum", "float32", "ici", "data")] == (
            bn_bytes, bn_bytes)
    # loss, scale, prec1 and prec5 in one fp32 all-reduce
    assert port_only[("trainer.metrics", "psum", "float32", "ici", "data")] == (16, 16)


# ------------------------------------------------------- TP 2 x PP 2 ledger

H, MB, VOCAB, M = 8, 4, 12, 4


def _tp_pp_data():
    rng = np.random.default_rng(3)
    f = lambda *shape: (rng.standard_normal(shape) * 0.3).astype(np.float32)  # noqa: E731
    return ({"w": f(2, H, H), "b": f(2, H)}, f(VOCAB, H),
            {"w": f(H, VOCAB), "b": f(VOCAB)},
            rng.integers(0, VOCAB, (M, MB)).astype(np.int32),
            rng.integers(0, VOCAB, (M, MB)).astype(np.int32))


def _jax_tp_pp_ledger():
    stacked, embed, head, tokens, labels = _tp_pp_data()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pipe", "tensor"))

    def stage(sp, x):
        h = jtp.column_parallel_linear(x, sp["w"], sp["b"], gather_output=True,
                                       axis_name="tensor")
        return jax.nn.gelu(h) + x

    def ce(logits, y):
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))

    def body(st, ep, hp, tok, y):
        tr = jax.lax.axis_index("tensor")
        sp = jax.tree.map(lambda v: v[0], st)
        sp = {"w": jax.lax.dynamic_slice_in_dim(sp["w"], tr * (H // 2), H // 2, axis=1),
              "b": jax.lax.dynamic_slice_in_dim(sp["b"], tr * (H // 2), H // 2)}
        loss, _ = jpp.forward_backward_pipelining_without_interleaving(
            stage, ce, sp, tok, y, embed_fn=lambda e, t: e[t], embed_params=ep,
            head_fn=lambda h_, x: x @ h_["w"] + h_["b"], head_params=hp)
        return loss

    jcomms.reset_comms_ledger()
    jax.jit(_shard_map(body, mesh=mesh, in_specs=(P("pipe"), P(), P(), P(), P()),
                       out_specs=P()))(jax.tree.map(jnp.asarray, stacked),
                                       jnp.asarray(embed),
                                       jax.tree.map(jnp.asarray, head),
                                       jnp.asarray(tokens), jnp.asarray(labels))
    return jcomms.comms_records()


def test_tp_pp_step_ledger_matches_one_jax_trace(world):
    jrec = _jax_tp_pp_ledger()
    key = lambda r: (r["site"], r["kind"], r["dtype"], r["scope"], r["axis"])  # noqa: E731
    theirs = {key(r): r for r in jrec}
    for rank in range(W):
        rec, ticks = world[rank][1 + len(TRAINERS)]
        mine = {key(r): r for r in rec}
        assert set(mine) == set(theirs)
        assert ticks == M + 2 * 2 - 1
        for k, r in theirs.items():
            m = mine[k]
            assert m["tier"] == r["tier"]
            assert m["bytes"] * r["calls"] == r["bytes"] * m["calls"], k
            if r["site"] in ("pp.fwd_ring", "pp.bwd_ring"):
                assert (m["calls"], m["bytes"]) == (ticks * r["calls"], ticks * r["bytes"])
            elif r["site"].startswith("pp."):
                assert (m["calls"], m["bytes"]) == (r["calls"], r["bytes"]), k
    sites = {r["site"] for r in jrec}
    assert {"tp.copy_to_region.bwd", "tp.gather_from_region", "pp.fwd_ring",
            "pp.bwd_ring", "pp.loss_allreduce", "pp.embed_head_allreduce"} <= sites
