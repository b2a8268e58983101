"""Port parity: ZeRO-2 (``optimizers/distributed_fused.py``), the bucketed
reduce-scatter and all-gather (``parallel/bucketing.py``) and the sharded
modes of ``ops/multi_tensor.py``, against the JAX package.

One spawned gloo world of 2 and one of 4 (``tests/_torch_world.py``
``zero_scenario``); the JAX side runs under ``shard_map`` over the first W
host devices with ``impl="jnp"``, as JAX's own ZeRO tests do.

* ``bucketed_psum_scatter`` / ``bucketed_all_gather`` at W 2 and 4, buckets
  smaller than the shard, ``concat=False``: bitwise JAX's on inputs whose
  sums are exact in any order; the compressed reduce-scatter on random
  inputs within ``wire_eps * sum |x|`` of the exact one and within two fp32
  ulps of JAX's (the same bf16 rows, summed in fp32 in rank order);
* ``DistributedFusedAdam`` for 3 steps with an overflow on one rank at step
  2 against JAX's at JAX's bound (rtol 1e-4, atol 1e-5,
  ``tests/test_distributed_optimizers.py:103-105``); ``overlap_backward``
  bitwise the phased step; bf16 params with fp32 masters;
* ``DistributedFusedLAMB`` with the clip engaged against JAX's at rtol
  2e-4, atol 2e-5 (JAX's own), a shard starting mid-tensor at W 2;
* the sharded ``per_tensor_sumsq`` and K8's plain shard mode against the
  unsharded ones;
* ``state_dict`` round trips, gathered and local;
* the ``zero2.*`` ledger of one step against one JAX trace;
* the refusals: ``hierarchical`` on a flat axis, LAMB with
  ``overlap_backward``; ``tuned`` with a manifest miss keeping the defaults.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu.monitor import comms as jcomms  # noqa: E402
from beforeholiday_tpu.optimizers import (  # noqa: E402
    DistributedFusedAdam as JZeroAdam,
    DistributedFusedLAMB as JZeroLAMB,
)
from beforeholiday_tpu.parallel import bucketing as jb  # noqa: E402
from beforeholiday_tpu_torch.ops import multi_tensor as tmt  # noqa: E402
from beforeholiday_tpu_torch.ops.arena import ArenaShard, make_spec  # noqa: E402
from beforeholiday_tpu_torch.optimizers import (  # noqa: E402
    DistributedFusedAdam,
    DistributedFusedLAMB,
    ZeRO3FusedAdam,
)
from beforeholiday_tpu_torch.optimizers.distributed_fused import _shard_len  # noqa: E402
from beforeholiday_tpu_torch.parallel import bucketing as tb  # noqa: E402

_shard_map = getattr(jax, "shard_map", None)
_CHECK_KW = "check_vma"
if _shard_map is None:
    from jax.experimental.shard_map import shard_map as _shard_map

    _CHECK_KW = "check_rep"


def shard_map(f, **kw):
    kw.setdefault(_CHECK_KW, False)
    return _shard_map(f, **kw)


SCATTER_N = 3000  # shard columns a rank: buckets of 4 KiB leave a ragged tail
SCATTER_BB = 4 * 1024
# 60,936 elements, padded to 65,536: at W 2 each rank's shard of 32,768
# starts inside "a"; at W 4 the shard is one TILE and ranks 2-3 hold padding
SHAPES = {"a": (300, 200), "b": (37, 19), "c": (128,), "d": (5, 3, 7)}
ZERO_BB = 64 * 1024  # several buckets a shard, splitting "a"
STEPS, SKIP_STEP = 3, 1  # step index 1 (the second) overflows on rank 1
ADAM_KW = dict(lr=1e-2, weight_decay=0.02)
LAMB_KW = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=0.5)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(W, seed, skip=True):
    rng = np.random.RandomState(seed)
    seq = [{k: rng.randn(W, *s).astype(np.float32) for k, s in SHAPES.items()}
           for _ in range(STEPS)]
    if skip:
        seq[SKIP_STEP]["c"][1, 5] = np.inf
    return seq


def _exact(W, seed):
    """Multiples of 2^-6 below 1 in magnitude: bf16-exact, and every sum of
    W of them is exact in fp32 whatever the order."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-64, 64, (W, W * SCATTER_N)) / 64.0).astype(np.float32)


def _cases(W):
    exact, rand = _exact(W, 1), np.random.RandomState(2).randn(
        W, W * SCATTER_N).astype(np.float32)
    cases = {}
    for name, x in (("exact", exact), ("rand", rand)):
        for compress in (False, True):
            cases[f"scatter_{name}_{compress}"] = dict(
                kind="scatter", x=x, bucket_bytes=SCATTER_BB, compress=compress,
                concat=True)
    cases["scatter_pieces"] = dict(kind="scatter", x=exact, bucket_bytes=SCATTER_BB,
                                   compress=False, concat=False)
    cases["scatter_whole"] = dict(kind="scatter", x=exact, bucket_bytes=None,
                                  compress=False, concat=True)
    cases["gather"] = dict(kind="gather", x=rand[:, :SCATTER_N],
                           bucket_bytes=SCATTER_BB)
    cases["gather_bf16"] = dict(kind="gather", x=exact[:, :SCATTER_N],
                                bucket_bytes=SCATTER_BB, wire="bfloat16")
    params = _params()
    cases["adam"] = dict(kind="adam", params=params, grads=_grads(W, 3),
                         kw=ADAM_KW)
    cases["adam_bucketed"] = dict(kind="adam", params=params, grads=_grads(W, 3),
                                  kw=dict(ADAM_KW, bucket_bytes=ZERO_BB))
    cases["adam_overlap"] = dict(kind="adam", params=params, grads=_grads(W, 3),
                                 kw=dict(ADAM_KW, bucket_bytes=ZERO_BB,
                                         overlap_backward=True))
    cases["adam_compressed"] = dict(kind="adam", params=params,
                                    grads=_grads(W, 3, skip=False),
                                    kw=dict(ADAM_KW, bucket_bytes=ZERO_BB,
                                            compress=True))
    cases["lamb"] = dict(kind="lamb", params=params, grads=_grads(W, 4), kw=LAMB_KW)
    if W == 2:
        cases["adam_bf16"] = dict(kind="adam", params=params, dtype="bfloat16",
                                  grads=_grads(W, 5, skip=False), kw=ADAM_KW)
        for kind, kw in (("adam", ADAM_KW), ("lamb", LAMB_KW)):
            seq = _grads(W, 6, skip=False) + _grads(W, 7, skip=False)[:1]
            cases[f"{kind}_straight"] = dict(kind=kind, params=params, grads=seq,
                                             kw=kw)
            cases[f"{kind}_resumed"] = dict(kind=kind, params=params, grads=seq,
                                            kw=kw, resume_at=2)
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {W: tw.run_world(tw.zero_scenario, W, tmp_path_factory.mktemp(f"zero{W}"),
                            _cases(W))
            for W in (2, 4)}


@pytest.fixture(scope="module")
def meshes():
    devices = jax.devices()
    return {W: Mesh(np.asarray(devices[:W]), ("data",)) for W in (2, 4)}


def _jax_scatter(mesh, x, bucket_bytes, compress, concat):
    W = x.shape[0]
    n_pieces = len(jb.bucket_slices(SCATTER_N, 4 * W, bucket_bytes)) if not concat else 1

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P("data"),
                       out_specs=tuple(P("data") for _ in range(n_pieces)))
    def run(v):
        out = jb.bucketed_psum_scatter(v[0], "data", site="t.scatter",
                                       bucket_bytes=bucket_bytes, compress=compress,
                                       concat=concat)
        out = out if isinstance(out, list) else [out]
        return tuple(o[None] for o in out)

    return [np.asarray(o) for o in run(jnp.asarray(x))]


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("compress", [False, True])
def test_bucketed_psum_scatter_is_bitwise_jax(worlds, meshes, W, compress):
    x = _exact(W, 1)
    ref = _jax_scatter(meshes[W], x, SCATTER_BB, compress, True)[0]
    for r in range(W):
        got = worlds[W][r][f"scatter_exact_{compress}"]
        np.testing.assert_array_equal(got, ref[r])
        # exact inputs: the wire rounds nothing, so compression changes no bit
        np.testing.assert_array_equal(got, worlds[W][r]["scatter_exact_False"])
        np.testing.assert_array_equal(got, worlds[W][r]["scatter_whole"])
        np.testing.assert_array_equal(got, x.sum(0)[r * SCATTER_N:(r + 1) * SCATTER_N])


@pytest.mark.parametrize("W", [2, 4])
def test_scatter_pieces_are_jax_pieces(worlds, meshes, W):
    ref = _jax_scatter(meshes[W], _exact(W, 1), SCATTER_BB, False, False)
    assert len(ref) == len(tb.bucket_slices(SCATTER_N, 4 * W, SCATTER_BB)) > 2
    for r in range(W):
        got = worlds[W][r]["scatter_pieces"]
        assert len(got) == len(ref)
        for g, j in zip(got, ref):
            np.testing.assert_array_equal(g, j[r])


@pytest.mark.parametrize("W", [2, 4])
def test_compressed_scatter_within_bound_and_jax(worlds, meshes, W):
    x = np.random.RandomState(2).randn(W, W * SCATTER_N).astype(np.float32)
    ref = _jax_scatter(meshes[W], x, SCATTER_BB, True, True)[0]
    exact = _jax_scatter(meshes[W], x, SCATTER_BB, False, True)[0]
    sum_abs = np.abs(x).sum(0)
    for r in range(W):
        got = worlds[W][r]["scatter_rand_True"]
        cols = slice(r * SCATTER_N, (r + 1) * SCATTER_N)
        # the reduce-scatter form keeps its result fp32: one wire rounding
        # of each input, wire_eps * sum |x| (half compression_error_bound)
        assert (np.abs(got - exact[r]) <= tb.wire_eps(torch.bfloat16) * sum_abs[cols]
                + 1e-6).all()
        assert (np.abs(got - exact[r])
                <= tb.compression_error_bound(sum_abs[cols])).all()
        # the same bf16 rows summed in fp32 in rank order; XLA's order may
        # differ by an ulp of the partial sums
        np.testing.assert_allclose(got, ref[r], rtol=2 ** -22, atol=2 ** -22 * W)
        np.testing.assert_allclose(worlds[W][r]["scatter_rand_False"], exact[r],
                                   rtol=2 ** -22, atol=2 ** -22 * W)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case, wire", [("gather", jnp.float32),
                                        ("gather_bf16", jnp.bfloat16)])
def test_bucketed_all_gather_is_bitwise_jax(worlds, meshes, W, case, wire):
    x = (np.random.RandomState(2).randn(W, W * SCATTER_N).astype(np.float32)
         if case == "gather" else _exact(W, 1))[:, :SCATTER_N]

    @jax.jit
    @functools.partial(shard_map, mesh=meshes[W], in_specs=P("data"), out_specs=P())
    def run(v):
        return jb.bucketed_all_gather(v[0].astype(wire), "data", site="t.gather",
                                      bucket_bytes=SCATTER_BB).astype(jnp.float32)

    ref = np.asarray(run(jnp.asarray(x)))
    np.testing.assert_array_equal(ref, x.reshape(-1))
    for r in range(W):
        np.testing.assert_array_equal(worlds[W][r][case], ref)


def _jax_run(mesh, opt, params, grads_seq, dtype=jnp.float32):
    """JAX's sharded optimizer over ``grads_seq`` (rank-stacked), from
    ``params``: the final params and the gathered masters."""
    W = mesh.devices.size

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P("data")),
                       out_specs=(P(), P()))
    def run(p, gs):
        state = opt.init(p)
        for g in gs:
            p, state = opt.step(p, jax.tree.map(lambda v: v[0], g), state)
        return p, opt.state_dict(p, state)["master"]

    p0 = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    gs = [{k: jnp.asarray(v) for k, v in g.items()} for g in grads_seq]
    assert all(next(iter(g.values())).shape[0] == W for g in gs)
    p, m = run(p0, gs)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), (p, m))


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case", ["adam", "adam_bucketed"])
def test_distributed_fused_adam_matches_jax(worlds, meshes, W, case):
    kw = dict(ADAM_KW, **({"bucket_bytes": ZERO_BB} if case != "adam" else {}))
    ref_p, ref_m = _jax_run(meshes[W], JZeroAdam(impl="jnp", **kw), _params(),
                            _grads(W, 3))
    for r in range(W):
        got = worlds[W][r][case]
        # the overflow on rank 1 at the second step skipped it on every rank
        assert got["steps"] == [1, 1, 2]
        for k in SHAPES:
            np.testing.assert_allclose(got["params"][k], ref_p[k], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got["master"][k], ref_m[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("W", [2, 4])
def test_overlap_backward_is_bitwise_the_phased_step(worlds, W):
    for r in range(W):
        a, b = worlds[W][r]["adam_overlap"], worlds[W][r]["adam_bucketed"]
        assert a["steps"] == b["steps"] == [1, 1, 2]
        for k in SHAPES:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
            np.testing.assert_array_equal(a["master"][k], b["master"][k])
        # and bucketing the phased step changes no bit either
        for k in SHAPES:
            np.testing.assert_array_equal(b["master"][k],
                                          worlds[W][r]["adam"]["master"][k])


@pytest.mark.parametrize("W", [2, 4])
def test_compressed_step_close_to_uncompressed_and_jax(worlds, meshes, W):
    kw = dict(ADAM_KW, bucket_bytes=ZERO_BB, compress=True)
    ref_p, ref_m = _jax_run(meshes[W], JZeroAdam(impl="jnp", **kw), _params(),
                            _grads(W, 3, skip=False))
    for r in range(W):
        got = worlds[W][r]["adam_compressed"]
        for k in SHAPES:
            np.testing.assert_allclose(got["master"][k], ref_m[k], rtol=1e-4, atol=1e-5)
            # the params came through the bf16 wire: a bf16 rounding of the
            # masters (JAX's contract)
            np.testing.assert_allclose(got["params"][k], got["master"][k],
                                       rtol=2 ** -8, atol=0)


def test_bf16_params_keep_fp32_masters(worlds):
    for r in range(2):
        got = worlds[2][r]["adam_bf16"]
        assert set(got["dtypes"].values()) == {"torch.bfloat16"}
        for k in SHAPES:
            master = torch.from_numpy(got["master"][k])
            np.testing.assert_array_equal(got["params"][k],
                                          master.to(torch.bfloat16).float().numpy())
            assert not np.array_equal(got["master"][k],
                                      master.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("W", [2, 4])
def test_distributed_fused_lamb_matches_jax(worlds, meshes, W):
    ref_p, ref_m = _jax_run(meshes[W], JZeroLAMB(impl="jnp", **LAMB_KW), _params(),
                            _grads(W, 4))
    for r in range(W):
        got = worlds[W][r]["lamb"]
        assert got["steps"] == [1, 1, 2]
        for k in SHAPES:
            np.testing.assert_allclose(got["params"][k], ref_p[k], rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(got["master"][k], ref_m[k], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_state_dict_round_trip(worlds, kind):
    W = 2
    spec = make_spec(list(SHAPES.values()))
    shard = _shard_len(spec.padded_total, W)
    for r in range(W):
        straight, resumed = worlds[W][r][f"{kind}_straight"], worlds[W][r][f"{kind}_resumed"]
        for k in SHAPES:
            np.testing.assert_array_equal(resumed["params"][k], straight["params"][k])
            np.testing.assert_array_equal(resumed["master"][k], straight["master"][k])
        sd = resumed["gathered"]
        assert int(sd["step"]) == 2
        for key in ("master", "exp_avg", "exp_avg_sq"):
            assert {k: v.shape for k, v in sd[key].items()} == SHAPES
            assert all(v.dtype == np.float32 for v in sd[key].values())
        local = resumed["local"]
        assert all(local[key].shape == (shard,) for key in ("master", "exp_avg",
                                                             "exp_avg_sq"))
    # the local shards are the gathered state's arena, rank by rank
    full = np.concatenate([worlds[W][r][f"{kind}_resumed"]["local"]["master"]
                           for r in range(W)])
    ref = np.concatenate([worlds[W][0][f"{kind}_resumed"]["gathered"]["master"][k]
                          .reshape(-1) for k in sorted(SHAPES)])
    np.testing.assert_array_equal(full[: ref.size], ref)
    assert not full[ref.size:].any()


def _jax_records(mesh, opt, params):
    W = mesh.devices.size
    g = {k: jnp.zeros((W, *v.shape), jnp.float32) for k, v in params.items()}

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P("data")), out_specs=P())
    def run(p, g):
        state = opt.init(p)
        return opt.step(p, jax.tree.map(lambda v: v[0], g), state)[0]

    jcomms.reset_comms_ledger()
    jax.jit(run).lower({k: jnp.asarray(v) for k, v in params.items()}, g)
    return sorted((r["site"], r["kind"], r["dtype"], r["calls"], r["bytes"],
                   r["logical_bytes"]) for r in jcomms.comms_records()
                  if str(r["site"]).startswith("zero2."))


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case, make, kw", [
    ("adam", JZeroAdam, ADAM_KW),
    ("adam_bucketed", JZeroAdam, dict(ADAM_KW, bucket_bytes=ZERO_BB)),
    ("adam_compressed", JZeroAdam, dict(ADAM_KW, bucket_bytes=ZERO_BB, compress=True)),
    ("lamb", JZeroLAMB, LAMB_KW)])
def test_zero2_ledger_matches_one_jax_trace(worlds, meshes, W, case, make, kw):
    ref = _jax_records(meshes[W], make(impl="jnp", **kw), _params())
    assert {r[0] for r in ref} >= {"zero2.reduce_scatter_grads", "zero2.found_inf"}
    for r in range(W):
        got = [tuple(x) for x in worlds[W][r][case]["records"]]
        assert got == ref


@pytest.mark.parametrize("W, tensors", [
    (2, SHAPES), (4, SHAPES),
    (3, {"x": (1,), "y": (40000,), "z": (3, 5), "w": (30000,), "v": (70000,)})])
def test_sharded_norms_and_k8_shard_mode_match_unsharded(W, tensors):
    spec = make_spec(list(tensors.values()))
    shard = _shard_len(spec.padded_total, W)
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(shard * W).astype(np.float32))
    x[spec.total:] = 0
    u = torch.from_numpy(rng.randn(shard * W).astype(np.float32))
    ratio = torch.from_numpy(rng.rand(spec.num_tensors).astype(np.float32))
    whole = tmt.per_tensor_sumsq(x[: spec.padded_total], spec)
    parts = [tmt.per_tensor_sumsq(x[r * shard:(r + 1) * shard], spec,
                                  ArenaShard(spec, r, shard)) for r in range(W)]
    np.testing.assert_allclose(sum(parts).numpy(), whole.numpy(), rtol=1e-6)
    # the JAX form (an id per element) gives the same partial sums; its
    # scatter_add sums each tensor's elements one by one, the dot products
    # in blocks: fp32 sums in two orders, 1e-4 relative over 32,768 terms
    ids = torch.arange(W * shard).reshape(W, shard)
    for r in range(W):
        seg = torch.bucketize(ids[r], torch.tensor([o + int(np.prod(s)) for o, s in
                                                    zip(spec.offsets, spec.shapes)]),
                              right=True)
        np.testing.assert_allclose(
            tmt.per_tensor_sumsq(x[r * shard:(r + 1) * shard], spec, seg).numpy(),
            parts[r].numpy(), rtol=1e-4)
        coef = tmt._segment_coef(ratio, spec, ArenaShard(spec, r, shard))
        np.testing.assert_array_equal(coef.numpy(), tmt._segment_coef(ratio, spec, seg))
    # K8's plain version on each shard is the unsharded update's slice
    p_whole = x.clone()
    tmt.scaled_update_torch(p_whole[: spec.padded_total], u[: spec.padded_total], ratio,
                            spec, found_inf=None, copy_out=None)
    for r in range(W):
        p = x[r * shard:(r + 1) * shard].clone()
        copy = torch.empty(shard, dtype=torch.bfloat16)
        tmt.scaled_update_torch(p, u[r * shard:(r + 1) * shard], ratio, spec,
                                found_inf=None, copy_out=copy,
                                shard=ArenaShard(spec, r, shard))
        np.testing.assert_array_equal(p.numpy(), p_whole[r * shard:(r + 1) * shard].numpy())
        assert torch.equal(copy, p.to(torch.bfloat16))
        # K8's tables from the shard's base: global first ids, padding last
        first, span, starts = tmt._segment_tables(spec, torch.device("cpu"),
                                                  r * shard, shard)
        lo = r * shard + np.arange(first.numel()) * tmt._BLOCK
        want = np.searchsorted(np.array(spec.offsets + (spec.total,)), lo,
                               side="right") - 1
        np.testing.assert_array_equal(first.numpy(), want)


def test_refusals(tmp_path):
    # the two-level knobs: hierarchical=True needs a (slice, intra) spec, as
    # in JAX; a tier's compression knob on a flat axis is kept, as in JAX
    with pytest.raises(ValueError, match="hierarchical=True needs"):
        DistributedFusedAdam(hierarchical=True)
    assert DistributedFusedAdam(compress_dcn=True)._tier_compress() == (False, True)
    with pytest.raises(NotImplementedError, match="overlap_backward"):
        DistributedFusedLAMB(overlap_backward=True)
    # tuned=True is no refusal since the autotuner's port: a manifest miss
    # keeps the shipped defaults, as in JAX (tests/test_torch_tune.py holds
    # the hits)
    missing = str(tmp_path / "missing.json")
    assert DistributedFusedAdam(tuned=True, tuning_manifest=missing).bucket_bytes is None
    assert ZeRO3FusedAdam(tuned=True, tuning_manifest=missing).prefetch == 1
    with pytest.raises(ValueError, match="hierarchical=True needs"):
        tb.BucketedReduce(hierarchical=True)


def test_arena_helpers_match_jax():
    """``segment_ids_of``, ``tree_flatten_arena`` / ``tree_unflatten_arena``
    and ``as_rows`` against the JAX package's, bitwise."""
    from beforeholiday_tpu.ops import arena as jarena
    from beforeholiday_tpu_torch.ops import arena as tarena

    params = _params()
    jflat, jspec, _ = jarena.tree_flatten_arena({k: jnp.asarray(v) for k, v in params.items()})
    tflat, tspec, tdef = tarena.tree_flatten_arena(tw._ttree(params))
    assert (tspec.offsets, tspec.total, tspec.padded_total) == (
        jspec.offsets, jspec.total, jspec.padded_total)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = tarena.tree_unflatten_arena(tflat, tspec, tdef)
    for k in SHAPES:
        np.testing.assert_array_equal(back[k].numpy(), params[k])
    assert tarena.as_rows(tflat).shape == np.asarray(jarena.as_rows(jflat)).shape
    idx = np.random.RandomState(3).randint(0, 2 * jspec.padded_total, 5000)
    np.testing.assert_array_equal(
        tarena.segment_ids_of(tspec, torch.from_numpy(idx)).numpy(),
        np.asarray(jarena.segment_ids_of(jspec, jnp.asarray(idx, jnp.int32))))
