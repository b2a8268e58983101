"""Port parity: ``parallel.parallel_state`` against the JAX package's, in a
gloo world of 8 processes against ``shard_map`` over the 8 host devices.
Global rank ``r`` of the port and device ``r`` of the JAX mesh hold the
same place in the (pipe, data, context, tensor) layout, so for each layout
(tp, pp, cp, a virtual pipeline, a split rank) every getter must agree
exactly: the ranks on each axis, the world sizes, the stage predicates
(with the virtual chunk at 0 and at its last), the pipeline neighbours, and
a sum over each axis's group (a collective, against ``psum``). The error
paths (an indivisible world, a virtual pipeline without pp >= 2) raise the
JAX module's errors, word for word; without a world, the port's entry
points raise as the JAX ones do without a mesh."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu.parallel import parallel_state as jps  # noqa: E402
from beforeholiday_tpu_torch.parallel import parallel_state as tps  # noqa: E402

W = 8
_shard_map = functools.partial(jax.shard_map, check_vma=False)
# (tp, pp, cp, vpp, split rank)
CONFIGS = [(2, 2, 1, None, None), (2, 1, 2, None, None), (1, 4, 1, 2, None),
           (1, 4, 1, None, 2), (8, 1, 1, None, None), (1, 1, 1, None, None),
           (1, 2, 2, None, 1)]
ERRORS = [dict(tensor_model_parallel_size=3),
          dict(virtual_pipeline_model_parallel_size=2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.run_world(tw.batch_scenario, W, tmp_path_factory.mktemp("ps"),
                        [("parallel_state_scenario", (CONFIGS,))])


def _jax_layout(devices8, tp, pp, cp, vpp, split, vrank=None):
    st = jps.initialize_model_parallel(
        tp, pp, context_parallel_size=cp, virtual_pipeline_model_parallel_size=vpp,
        pipeline_model_parallel_split_rank=split, devices=devices8)
    if vrank is not None:
        jps.set_virtual_pipeline_model_parallel_rank(vrank)
    mesh = jps.get_mesh()

    def f(r):
        v = r[0]
        out = [jps.get_tensor_model_parallel_rank(), jps.get_pipeline_model_parallel_rank(),
               jps.get_data_parallel_rank(), jps.get_context_parallel_rank(),
               jps.is_pipeline_first_stage(), jps.is_pipeline_last_stage(),
               jps.is_pipeline_stage_before_split(), jps.is_pipeline_stage_after_split(),
               jps.get_pipeline_model_parallel_next_rank(),
               jps.get_pipeline_model_parallel_prev_rank()]
        out += [jax.lax.psum(v, a) for a in jps.MESH_AXIS_NAMES]
        return jnp.stack([jnp.asarray(o, jnp.int32) for o in out])[None]

    spec = P(("pipe", "data", "context", "tensor"))
    rows = np.asarray(jax.jit(_shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec))(
        jnp.arange(W, dtype=jnp.int32)))
    sizes = (st.tensor_model_parallel_size, st.pipeline_model_parallel_size,
             st.data_parallel_size, st.context_parallel_size)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    return rows, sizes, ids


@pytest.mark.parametrize("index", range(len(CONFIGS)),
                         ids=["tp{}-pp{}-cp{}-vpp{}-split{}".format(*c) for c in CONFIGS])
def test_layout_matches_jax(world, devices8, index):
    tp, pp, cp, vpp, split = CONFIGS[index]
    rows, sizes, ids = _jax_layout(devices8, tp, pp, cp, vpp, split)
    first_id = min(d.id for d in devices8)
    np.testing.assert_array_equal(ids - first_id, np.arange(W).reshape(pp, -1, cp, tp))
    for rank, per_rank in enumerate(world):
        r = per_rank[0][0][index]
        want = rows[rank]
        assert r["ranks"] == tuple(int(v) for v in want[:4])
        assert r["sizes"] == sizes
        assert (r["first"], r["last"], r["before"], r["after"]) == tuple(
            bool(v) for v in want[4:8])
        assert (r["next"], r["prev"]) == (int(want[8]), int(want[9]))
        assert tuple(r["sums"][a] for a in tps.MESH_AXIS_NAMES) == tuple(
            int(v) for v in want[10:])
        assert r["grid"] == np.arange(W).reshape(pp, -1, cp, tp).tolist()
        assert r["info"] == (r["ranks"][2], r["ranks"][0], r["ranks"][1], r["ranks"][3])
        for axis, members in r["members"].items():
            assert rank in members and len(members) == {
                "tensor": tp, "pipe": pp, "context": cp, "data": W // (tp * pp * cp)}[axis]
    if vpp is not None:
        rows, _, _ = _jax_layout(devices8, tp, pp, cp, vpp, split, vrank=vpp - 1)
        for rank, per_rank in enumerate(world):
            assert per_rank[0][0][index]["first_last_vchunk"] == (
                bool(rows[rank][4]), bool(rows[rank][5]))


def test_error_paths_match_jax(world, devices8):
    for kw, got in zip(ERRORS, world[0][0][1]):
        with pytest.raises(RuntimeError) as e:
            jps.initialize_model_parallel(devices=devices8, **kw)
        assert got == str(e.value)
    # every rank raised, and a failed init leaves no state behind
    for per_rank in world:
        _, errors, initialized, info = per_rank[0]
        assert all(isinstance(m, str) for m in errors)
        assert not initialized and info == (0, 0, 0, 0)


def test_without_a_world():
    """No process group: the port's entry points raise, as the JAX ones do
    without a mesh, and the data axis names no group."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        tps.initialize_model_parallel()
    with pytest.raises(RuntimeError, match="not initialized"):
        tps.get_state()
    with pytest.raises(RuntimeError, match="not initialized"):
        jps.get_state()
    with pytest.raises(RuntimeError, match="not initialized"):
        tps.get_group("data")
    assert not tps.model_parallel_is_initialized()
    assert tps.get_rank_info() == jps.get_rank_info() == (0, 0, 0, 0)
    assert tps.get_data_parallel_rank() == 0


@pytest.mark.parametrize("spec", ["data", ("data",), ("slice", "intra"),
                                  ["pipe", "tensor"]])
def test_hierarchical_axes_matches_jax(spec):
    assert tps.hierarchical_axes(spec) == jps.hierarchical_axes(spec)
    with pytest.raises(ValueError):
        tps.hierarchical_axes(("a", "b", "c"))
    with pytest.raises(ValueError):
        jps.hierarchical_axes(("a", "b", "c"))
