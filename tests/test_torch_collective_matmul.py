"""Port parity: the collective matmul (``transformer/tensor_parallel/
collective.py``) in one gloo world of 4 processes, against the JAX
package's under ``shard_map`` (cf. ``tests/test_collective_matmul.py``).

* The sequence-parallel ``column_parallel_linear`` with the collective
  matmul is its monolithic gather-then-GEMM path bit for bit: y, dx, dw and
  db, at TP 2 and 4, fp32 and bf16, 2-D and 3-D activations.
* Against JAX's ``all_gather_matmul`` at TP 2 and 4 with 3-D activations,
  fp32: forward, dx and dw bitwise. The operands are small multiples of
  powers of two, so every product and every sum is exact and the bits do
  not depend on the order two GEMM libraries sum in.
* The ledger: the hop sites ``tp.collective_matmul:hop{t}`` and the
  backward's ``tp.collective_matmul.bwd_dx`` as JAX books them (kind, calls
  and bytes); the knob off by default, ``set_collective_matmul`` returning
  the previous value and driving ``collective_matmul=None``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu.monitor import comms as jcomms  # noqa: E402
from beforeholiday_tpu.transformer.tensor_parallel import collective as jcm  # noqa: E402
from beforeholiday_tpu_torch.transformer.tensor_parallel import collective as tcm  # noqa: E402

S, B, K, N = 16, 4, 8, 32


def _random(tp, dtype, three_d, seed):
    rng = np.random.default_rng(seed)
    lead = (S, B) if three_d else (S * B,)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    dy = rng.standard_normal((*lead, N)).astype(np.float32)
    return x, w, b, dy, dtype


def _exact(tp, seed):
    """Integers times powers of two: every product and sum exact in fp32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (S, B, K)).astype(np.float32)
    w = (rng.integers(-4, 5, (K, N)) / 8.0).astype(np.float32)
    dy = (rng.integers(-4, 5, (S, B, N)) / 4.0).astype(np.float32)
    return x, w, None, dy, "float32"


CASES = {f"tp{tp}_{dt}_{'3d' if d3 else '2d'}": (tp, _random(tp, dt, d3, 10 * tp + d3))
         for tp in (2, 4) for dt in ("float32", "bfloat16") for d3 in (False, True)}
CASES.update({f"tp{tp}_exact": (tp, _exact(tp, tp)) for tp in (2, 4)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [(name, tp, *ops) for name, (tp, ops) in CASES.items()]
    return tw.run_world(tw.collective_matmul_scenario, 4,
                        tmp_path_factory.mktemp("cm"), cases)


@pytest.mark.parametrize("name", [n for n in CASES if "exact" not in n])
def test_collective_is_the_monolithic_path_bitwise(world, name):
    for rank in range(4):
        mono, ring = world[rank][name][False][0], world[rank][name][True][0]
        for what, a, b in zip(("y", "dx", "dw", "db"), mono, ring):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} rank {rank} {what}")


def _jax(tp, x, w, dy):
    mesh = Mesh(np.asarray(jax.devices()[:tp]), ("tensor",))

    def body(xs, ws, dys):
        y, pull = jax.vjp(lambda a, c: jcm.all_gather_matmul(a, c, "tensor"), xs, ws)
        return (y, *pull(dys))

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(P("tensor"), P(None, "tensor"), P(None, None, "tensor")),
                      out_specs=(P(None, None, "tensor"), P("tensor"), P(None, "tensor")),
                      check_vma=False)
    jcomms.reset_comms_ledger()
    out = jax.jit(f)(*(jnp.asarray(a) for a in (x, w, dy)))
    return [np.asarray(o) for o in out], jcomms.comms_records()


@pytest.mark.parametrize("tp", [2, 4])
def test_all_gather_matmul_bitwise_jax(world, tp):
    x, w, _, dy, _ = CASES[f"tp{tp}_exact"][1]
    (jy, jdx, jdw), jrec = _jax(tp, x, w, dy)
    s, n = S // tp, N // tp
    for rank in range(tp):  # the first tensor group: world ranks 0 .. tp-1
        grads, records = world[rank][f"tp{tp}_exact"][True]
        y, dx, dw = grads[:3]
        np.testing.assert_array_equal(y, jy[..., rank * n:(rank + 1) * n])
        np.testing.assert_array_equal(dx, jdx[rank * s:(rank + 1) * s])
        np.testing.assert_array_equal(dw, jdw[:, rank * n:(rank + 1) * n])
        mine = {r["site"]: r for r in records if r["site"].startswith("tp.collective")}
        ref = {r["site"]: r for r in jrec if r["site"].startswith("tp.collective")}
        assert set(mine) == set(ref) == {f"tp.collective_matmul:hop{t}"
                                         for t in range(1, tp)} | {
            "tp.collective_matmul.bwd_dx"}
        for site, r in ref.items():
            for k in ("kind", "calls", "bytes"):
                assert mine[site][k] == r[k], (site, k)


def test_knob(world):
    for rank in range(4):
        (prev0, on0, sites0), (prev1, on1, sites1) = world[rank]["knob"]
        assert (prev0, on0) == (False, False) and (prev1, on1) == (False, True)
        assert not any("collective_matmul" in s for s in sites0)
        assert "tp.collective_matmul:hop1" in sites1
    assert tcm.collective_matmul_enabled() is False
    prev = tcm.set_collective_matmul(True)
    try:
        assert prev is False and tcm.collective_matmul_enabled() is True
    finally:
        assert tcm.set_collective_matmul(False) is True
