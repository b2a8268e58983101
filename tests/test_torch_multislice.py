"""Port parity: the two-level (slice x intra) data-parallel engines
(``parallel/bucketing.py``'s two-level section, ``parallel_state``'s mesh
carvers, ``distributed``'s and ``overlap``'s ``hierarchical=True``, ZeRO-2
and ZeRO-3 over a two-level spec) against the port's flat engines and the
JAX package, the counterpart of ``tests/test_multislice.py``.

Spawned gloo worlds through ``tests/_torch_world.py``
``multislice_scenario``: a 2 x 2 carve of a world of 4 holds every case;
the degenerate carves 4 x 1, 1 x 4 and 1 x 1 the collective counts, the
bits and the DCN knob. The JAX side runs under ``shard_map`` over a 2 x 2
``make_two_level_mesh`` of the first 4 host devices, ``impl="jnp"``.

* Bitwise within the port at 2 x 2 (each tier two ranks, so each tier's
  sum is a two-term sum, which commutes): ``reduce_gradients`` flat against
  ``hierarchical=True`` at four bucket sizes, the packed-arena reduce, the
  backward-time hooks (the tree hook and the arena hooks, flat and
  hierarchical), ZeRO-2 flat against hierarchical, ZeRO-3 hierarchical
  ("keep" and "regather") against ZeRO-2 hierarchical.
* Against JAX at JAX's bounds (rtol 1e-4, atol 1e-5): the reduce, the
  hooked grads, ZeRO-2's params and every master shard.
* Compression per tier within ``hierarchical_compression_error_bound``;
  the bound 0 uncompressed, and JAX's bound function's values.
* The ledger: DCN bytes of the hierarchical reduce and reduce-scatter
  flat's / slice size; compressing the DCN tier halves its wire, the intra
  tier's ratio stays 1; the per-tier bytes equal one JAX trace's.
* The tripwire: clean ranks pass; a perturbed rank in slice 1 trips the
  flag on every rank.
* Degenerate carves: the hierarchical reduce emits exactly the flat path's
  collectives, bitwise; the reduce-scatter and gather fall back to the
  surviving tier's one collective; the full carve emits the tier
  collectives.
* ``bucket_bytes_dcn`` is bitwise wherever each tier's sum is (the 4 x 1
  carve's tier of four re-bucketed is held at JAX's bound: gloo's sum order
  there follows the collective's size), moves the DCN call count and not
  the bytes; ``BucketedReduce`` threads and validates it.
* The carvers' validation and layouts; ``hierarchical=True`` on a flat
  axis refused everywhere.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu.monitor import comms as jcomms  # noqa: E402
from beforeholiday_tpu.optimizers import DistributedFusedAdam as JZeroAdam  # noqa: E402
from beforeholiday_tpu.parallel import bucketing as jb  # noqa: E402
from beforeholiday_tpu.parallel import distributed as jdist  # noqa: E402
from beforeholiday_tpu.parallel.parallel_state import (  # noqa: E402
    make_two_level_mesh as jmesh,
)
from beforeholiday_tpu_torch.optimizers import (  # noqa: E402
    DistributedFusedAdam,
    ZeRO3FusedAdam,
)
from beforeholiday_tpu_torch.parallel import bucketing as tb  # noqa: E402
from beforeholiday_tpu_torch.parallel import distributed as tdist  # noqa: E402
from beforeholiday_tpu_torch.parallel import parallel_state as tps  # noqa: E402

_shard_map = getattr(jax, "shard_map", None)
_CHECK_KW = "check_vma"
if _shard_map is None:
    from jax.experimental.shard_map import shard_map as _shard_map

    _CHECK_KW = "check_rep"


def shard_map(f, **kw):
    kw.setdefault(_CHECK_KW, False)
    return _shard_map(f, **kw)


AX = ("slice", "intra")
BB = 16 * 1024
BUCKETS = [1024, 8192, BB, 1 << 20]
COMBOS = [(True, False), (False, True), (True, True), (False, False)]
DCN_BYTES = [512, 1 << 20]
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(37, 19).astype(np.float32),
            "w2": rng.randn(128).astype(np.float32),
            "w3": rng.randn(5, 3, 7).astype(np.float32)}


def _vec(seed, n=1000):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _full_cases():
    return {
        "reduce": dict(kind="reduce", grads=_tree(1), bucket_bytes=BUCKETS),
        "packed": dict(kind="packed_reduce", grads=_tree(1), bb=BB),
        "overlap": dict(kind="overlap", params=_tree(0), grads=_tree(1), bb=BB),
        "zero2": dict(kind="zero2", params=_tree(0), grads=_tree(1), bb=BB),
        "compress": dict(kind="compress", x=_vec(7), combos=COMBOS),
        "ledger": dict(kind="ledger", n=128 * 256, bb=BB),
        "tripwire": dict(kind="tripwire", grads=_tree(1), bad_rank=3, bb=BB),
        "coll": dict(kind="collectives", x=_vec(0, 1024)),
        "dcn": dict(kind="dcn_knob", x=_vec(3), dcn_bytes=DCN_BYTES),
        "mesh": dict(kind="mesh"),
    }


def _degenerate_cases():
    return {
        "reduce": dict(kind="reduce", grads=_tree(1), bucket_bytes=[1024]),
        "zero2": dict(kind="zero2", params=_tree(0), grads=_tree(1), bb=BB),
        "coll": dict(kind="collectives", x=_vec(0, 1024)),
        "dcn": dict(kind="dcn_knob", x=_vec(3), dcn_bytes=DCN_BYTES),
        "mesh": dict(kind="mesh"),
    }


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """Every rank's results on the 2 x 2 carve of a world of 4."""
    return tw.run_world(tw.multislice_scenario, 4, tmp_path_factory.mktemp("ms"),
                        2, 2, _full_cases(), timeout=300)


GEOMETRIES = [(4, 1), (1, 4), (1, 1)]


@pytest.fixture(scope="module")
def degenerate(tmp_path_factory):
    """Every rank's results on each degenerate carve."""
    out = {}
    for n_slices, slice_size in GEOMETRIES:
        W = n_slices * slice_size
        out[(n_slices, slice_size)] = tw.run_world(
            tw.multislice_scenario, W, tmp_path_factory.mktemp("msd"), n_slices,
            slice_size, _degenerate_cases(), timeout=300)
    return out


# ---------------------------------------------------------------- the JAX side


@pytest.fixture(scope="module")
def jax_mesh():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    return jmesh(2, 2, devices=devs[:4])


def _jrun(mesh, fn, *args, out_specs=P()):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                             out_specs=out_specs))(*args)


def _jflat_rank():
    return jax.lax.axis_index(AX[0]) * 2 + jax.lax.axis_index(AX[1])


def _jdistinct(tree):
    c = 1.0 + 0.125 * _jflat_rank().astype(jnp.float32)
    return jax.tree.map(lambda x: x * c, tree)


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, **tol):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **(tol or JAX_TOL))


def _bitwise(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


# ------------------------------------------------------------------- the mesh


def test_mesh_indices_and_groups(full):
    for rank, r in enumerate(full):
        m = r["mesh"]
        assert m["flat_rank"] == m["joint_rank"] == rank
        assert m["index"] == {"slice": rank // 2, "intra": rank % 2}
        assert m["shape"] == {"slice": 2, "intra": 2}
        assert m["sizes"] == [2, 2] and m["static"] == 4


def test_carvers_validate_as_jax(full, jax_mesh):
    errors = full[0]["carvers"]["errors"]
    assert errors == {"zero_slices": "ValueError", "indivisible": "RuntimeError",
                      "too_big": "RuntimeError", "carve_too_big": "ValueError"}
    devs = jax.devices()[:4]
    with pytest.raises(ValueError):
        jmesh(0, devices=devs)
    with pytest.raises(RuntimeError):
        jmesh(3, devices=devs)
    with pytest.raises(RuntimeError):
        jmesh(4, 2, devices=devs)
    assert jax_mesh.axis_names == AX and jax_mesh.devices.shape == (2, 2)


def test_moe_and_carved_meshes_match_jax(full):
    from beforeholiday_tpu.parallel import parallel_state as jps

    devs = jax.devices()[:4]
    jm = jps.make_moe_mesh(data=2, expert=2, devices=devs)
    jones = jps.make_moe_mesh(devices=devs)
    jcarved = jps.carve_data_mesh(2, devices=devs)
    for rank, r in enumerate(full):
        c = r["carvers"]
        assert c["moe_axes"] == tuple(jm.axis_names)
        assert tuple(c["moe_shape"].values()) == jm.devices.shape
        assert c["moe_index"] == {"data": rank // 2, "expert": rank % 2}
        assert c["ones_axes"] == tuple(jones.axis_names)
        assert tuple(c["ones_shape"].values()) == jones.devices.shape
        # the first two ranks, in order; the psum over the carved group
        assert c["carved_index"] == ({"data": rank} if rank < 2 else None)
        assert c["carved_sum"] == (2.0 if rank < 2 else None)
    assert jcarved.devices.shape == (2,)


@pytest.mark.parametrize("spec", ["data", ("data",), AX, ["pipe", "tensor"]])
def test_hierarchical_axes_normalization(spec):
    from beforeholiday_tpu.parallel.parallel_state import hierarchical_axes

    assert tps.hierarchical_axes(spec) == hierarchical_axes(spec)


def test_flat_axis_rejected_everywhere():
    """hierarchical=True without a two-level spec fails at construction or
    call, in every engine that has the knob, as in JAX."""
    with pytest.raises(ValueError):
        tdist.reduce_gradients({}, axis_name="data", hierarchical=True)
    with pytest.raises(ValueError):
        tdist.Reducer(axis_name="data", hierarchical=True)
    with pytest.raises(ValueError):
        tdist.DistributedDataParallel(axis_name="data", hierarchical=True)
    with pytest.raises(ValueError):
        DistributedFusedAdam(lr=1e-2, axis_name="data", hierarchical=True)
    with pytest.raises(ValueError):
        ZeRO3FusedAdam(lr=1e-2, axis_name="data", hierarchical=True)
    with pytest.raises(ValueError):
        tb.BucketedReduce(bucket_bytes_dcn=1 << 20)
    with pytest.raises(ValueError):
        tb.bucketed_tree_psum([], "data", site="t", hierarchical=True)


# --------------------------------------------------------- bitwise to the flat


@pytest.mark.parametrize("bb", BUCKETS)
def test_reduce_gradients_bitwise_flat(full, bb):
    for r in full:
        flat, hier = r["reduce"][bb]
        assert _bitwise(flat, hier)


@pytest.mark.parametrize("bb", BUCKETS)
def test_reduce_gradients_matches_jax(full, jax_mesh, bb):
    grads = _jtree(_tree(1))
    want = _jrun(jax_mesh, lambda g: jdist.reduce_gradients(
        _jdistinct(g), axis_name=AX, bucket_bytes=bb, hierarchical=True), grads)
    _close(full[0]["reduce"][bb][1], want)


def test_packed_arena_reduce_bitwise_flat(full):
    for r in full:
        flat, hier = r["packed"]
        assert all(np.array_equal(a, b) for a, b in zip(flat, hier))


@pytest.mark.parametrize("path", ["hier", "arena_flat", "arena_hier"])
def test_overlap_hooks_bitwise_flat(full, path):
    for r in full:
        assert _bitwise(r["overlap"]["flat"], r["overlap"][path])


def test_overlap_hooks_match_jax(full, jax_mesh):
    params, grads = _jtree(_tree(0)), _jtree(_tree(1))

    def loss_fn(p, g):
        return sum(jnp.vdot(p[k], g[k]) for k in g)

    ddp = jdist.DistributedDataParallel(axis_name=AX, bucket_bytes=BB,
                                        hierarchical=True, overlap_backward=True)
    _, want = _jrun(jax_mesh, lambda p, g: ddp.value_and_grad(loss_fn)(
        p, _jdistinct(g)), params, grads, out_specs=(P(), P()))
    _close(full[0]["overlap"]["arena_hier"], want)


def test_zero2_hierarchical_bitwise_flat(full):
    for r in full:
        z = r["zero2"]
        assert np.array_equal(z["flat"]["master"], z["hier"]["master"])
        assert _bitwise(z["flat"]["params"], z["hier"]["params"])


def test_zero2_hierarchical_matches_jax(full, jax_mesh):
    params, grads = _jtree(_tree(0)), _jtree(_tree(1))
    opt = JZeroAdam(lr=1e-2, weight_decay=0.02, impl="jnp", axis_name=AX,
                    bucket_bytes=BB, hierarchical=True)

    def body(p, g):
        g = _jdistinct(g)
        state = opt.init(p)
        for _ in range(2):
            p, state = opt.step(p, g, state)
        return p, state["master"]

    p, masters = _jrun(jax_mesh, body, params, grads, out_specs=(P(), P(AX)))
    _close(full[0]["zero2"]["hier"]["params"], p)
    got = np.concatenate([r["zero2"]["hier"]["master"] for r in full])
    np.testing.assert_allclose(got, np.asarray(masters), **JAX_TOL)


@pytest.mark.parametrize("residency", ["keep", "regather"])
def test_zero3_hierarchical_bitwise_zero2(full, residency):
    for r in full:
        z = r["zero2"]
        assert np.array_equal(z[f"z3_{residency}"]["master"], z["hier"]["master"])
        assert _bitwise(z[f"z3_{residency}"]["params"], z["hier"]["params"])


def test_zero3_regather_runs_the_two_level_gather_again(full):
    """The hierarchical gather stays inside the custom op: "regather" runs
    it again in the backward, on both tiers."""
    keep, again = (full[0]["zero2"][f"z3_{k}"]["calls"] for k in ("keep", "regather"))
    assert set(keep) == {"dcn", "ici"}
    assert again["dcn"] > keep["dcn"] and again["ici"] > keep["ici"]


# ----------------------------------------------------------------- compression


@pytest.mark.parametrize("ci,cd", COMBOS)
def test_compression_within_composed_bound(full, ci, cd):
    for r in full:
        comp, exact, bound = r["compress"][(ci, cd)]
        assert np.all(np.abs(comp - exact) <= bound), float(
            np.max(np.abs(comp - exact) - bound))
        if not (ci or cd):
            assert np.array_equal(comp, exact) and not bound.any()


@pytest.mark.parametrize("ci,cd", COMBOS)
def test_compression_bound_matches_jax(ci, cd):
    s = np.float32(100.0)
    got = tb.hierarchical_compression_error_bound(s, compress_intra=ci,
                                                  compress_dcn=cd)
    want = jb.hierarchical_compression_error_bound(jnp.float32(s), compress_intra=ci,
                                                   compress_dcn=cd)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


# ---------------------------------------------------------------------- ledger


def test_ledger_dcn_bytes_are_flat_over_slice_size(full):
    led = full[0]["ledger"]
    assert led["flat"]["dcn"]["bytes"] / led["hier"]["dcn"]["bytes"] == 2.0
    assert led["flat_rs"]["dcn"]["bytes"] / led["hier_rs"]["dcn"]["bytes"] == 2.0
    assert led["hier"]["ici"]["bytes"] > 0 and led["hier_rs"]["ici"]["bytes"] > 0


def test_per_tier_compression_ratio(full):
    row = full[0]["ledger"]["hier_cdcn"]
    assert row["dcn"]["compression_ratio"] > 1.5
    assert row["ici"]["compression_ratio"] == 1.0


@pytest.mark.parametrize("name", ["flat", "hier", "hier_cdcn", "flat_rs",
                                  "hier_rs", "flat_ag", "hier_ag"])
def test_ledger_tiers_match_one_jax_trace(full, jax_mesh, name):
    n, world = 128 * 256, 4
    fns = {
        "flat": lambda a: jb.bucketed_psum(a, AX, site="tms.x", bucket_bytes=BB),
        "hier": lambda a: jb.hierarchical_psum(a, AX, site="tms.x", bucket_bytes=BB),
        "hier_cdcn": lambda a: jb.hierarchical_psum(a, AX, site="tms.x",
                                                    bucket_bytes=BB,
                                                    compress_dcn=True),
        "flat_rs": lambda a: jb.bucketed_psum_scatter(a, AX, site="tms.x",
                                                      bucket_bytes=BB),
        "hier_rs": lambda a: jb.hierarchical_psum_scatter(a, AX, site="tms.x",
                                                          bucket_bytes=BB),
        "flat_ag": lambda a: jb.bucketed_all_gather(a[: n // world], AX, site="tms.x",
                                                    bucket_bytes=BB),
        "hier_ag": lambda a: jb.hierarchical_all_gather(a[: n // world], AX,
                                                        site="tms.x",
                                                        bucket_bytes=BB),
    }
    jcomms.reset_comms_ledger()
    jax.make_jaxpr(shard_map(fns[name], mesh=jax_mesh, in_specs=(P(),),
                             out_specs=P(AX) if name.endswith("_rs") else P()))(
        jnp.zeros((n,), jnp.float32))
    row = next(r for r in jcomms.comms_summary() if r["subsystem"] == "tms")
    want = {t: (v["calls"], v["bytes"]) for t, v in row["by_tier"].items()}
    got = {t: (v["calls"], v["bytes"]) for t, v in full[0]["ledger"][name].items()}
    jcomms.reset_comms_ledger()
    assert got == want


# -------------------------------------------------------------------- tripwire


def test_tripwire_clean_ranks_pass(full):
    assert not any(r["tripwire"]["clean"] for r in full)


def test_tripwire_perturbed_rank_in_other_slice_trips_everywhere(full):
    assert all(r["tripwire"]["perturbed"] for r in full)


# ---------------------------------------------------------- degenerate carves


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_degenerate_carve_emits_flat_collectives(degenerate, geom):
    """A size-1 tier drops out: the hierarchical reduce issues exactly the
    flat path's collectives (counted on the ledger), with the flat path's
    bits; the reduce-scatter and the gather fall back to the surviving
    tier's single collective and give the flat path's values (a tier of
    four sums in gloo's order, so those are held at JAX's bound)."""
    for r in degenerate[geom]:
        (kf, vf), (kh, vh) = r["coll"][("psum", False)], r["coll"][("psum", True)]
        assert kf == kh and set(kh) <= {"psum"}, (kf, kh)
        assert np.array_equal(vf, vh)
        for name in ("psum_scatter", "all_gather"):
            (kf, vf), (kh, vh) = r["coll"][(name, False)], r["coll"][(name, True)]
            assert set(kh) <= {name} and sum(kh.values()) <= sum(kf.values())
            np.testing.assert_allclose(vh, vf, **JAX_TOL)
        if geom == (1, 1):
            assert not any(r["coll"][(n, True)][0] for n in ("psum", "psum_scatter",
                                                             "all_gather"))


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_degenerate_carve_engines_bitwise_flat(degenerate, geom):
    for r in degenerate[geom]:
        flat, hier = r["reduce"][1024]
        assert _bitwise(flat, hier)
        z = r["zero2"]
        assert np.array_equal(z["flat"]["master"], z["hier"]["master"])
        assert np.array_equal(z["z3_keep"]["master"], z["hier"]["master"])


def test_full_carve_emits_tier_collectives(full):
    kinds, _ = full[0]["coll"][("psum", True)]
    assert kinds.get("psum_scatter", 0) > 0 and kinds.get("all_gather", 0) > 0
    assert kinds.get("psum", 0) > 0
    flat, _ = full[0]["coll"][("psum", False)]
    assert set(flat) == {"psum"}


# ---------------------------------------------------------------- the DCN knob


@pytest.mark.parametrize("dcn", DCN_BYTES)
@pytest.mark.parametrize("geom", [(2, 2)] + GEOMETRIES,
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_dcn_knob_bitwise_at_mixed_geometries(full, degenerate, geom, dcn):
    """Bitwise wherever each tier's sum is: tiers of two, or a carve whose
    surviving tier keeps the flat bucket geometry. The 4 x 1 carve puts a
    tier of four under the DCN bucket size, where gloo's sum order follows
    the collective's size: held at JAX's bound there."""
    world = full if geom == (2, 2) else degenerate[geom]
    for r in world:
        if geom == (4, 1):
            np.testing.assert_allclose(r["dcn"][dcn][0], r["dcn"]["flat"], **JAX_TOL)
        else:
            assert np.array_equal(r["dcn"]["flat"], r["dcn"][dcn][0])


def test_dcn_regrouping_moves_calls_not_bytes(full):
    d = full[0]["dcn"]
    assert d["follow"]["calls"] == 4
    assert d[1 << 20][1]["calls"] == 1
    assert d[1 << 20][1]["bytes"] == d["follow"]["bytes"]


def test_bucketed_reduce_threads_and_validates(full):
    x = _vec(3)[:300]
    np.testing.assert_allclose(full[0]["dcn"]["policy"], x * 4, rtol=1e-6)
    pol = tb.BucketedReduce(axis_name=AX, hierarchical=True, compress=True,
                            compress_dcn=False)
    assert pol._tier_compress() == (True, False)
