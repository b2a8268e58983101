"""Port parity: ring attention over the context group
(``transformer/context_parallel.py``) in one gloo world of 4 processes,
against the JAX package's ``ring_attention`` under ``shard_map`` on the same
numpy inputs, at the bounds of ``tests/test_context_parallel.py``.

* The flash hops (K2/K4's plain versions, merged by log-sum-exp) against
  JAX's Pallas hops (interpret mode), and the fp32 online-softmax hops
  against JAX's jnp hops: cp 2 and 4, causal and not, fp32 (flash 3e-5,
  online 2e-5, atol and rtol), and bf16 (3e-2): the forward and the
  gradients of ``sum(out * w)`` with respect to q, k and v, whose backward
  sends the gradient K/V around the ring the opposite way (the transpose of
  JAX's ``ppermute``; K4 takes the merge's ``dlse``).
* The ledger: the forward hops at JAX's site ``cp.ring_attention.kv``, each
  call's bytes equal to those of the call JAX traced, ``cp - 1`` times JAX's
  calls (JAX books the loop body once); the backward hops, which JAX's
  ledger does not see, counted apart at ``cp.ring_attention.kv.bwd``.
"""

import functools
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
from beforeholiday_tpu.transformer.context_parallel import ring_attention  # noqa: E402

B, H, SL, D, SCALE = 1, 1, 128, 8, 0.3  # S_local 128: JAX's flash gate
TOL = {("flash", "float32"): 3e-5, ("online", "float32"): 2e-5,
       ("flash", "bfloat16"): 3e-2, ("online", "bfloat16"): 3e-2}
CASES = ([(path, cp, causal, "float32") for path in ("flash", "online")
          for cp in (2, 4) for causal in (False, True)]
         + [("flash", 4, True, "bfloat16"), ("flash", 2, False, "bfloat16"),
            ("online", 4, True, "bfloat16")])


def _name(case):
    path, cp, causal, dtype = case
    return f"{path}_cp{cp}_{'causal' if causal else 'full'}_{dtype}"


def _inputs(cp):
    rng = np.random.default_rng(cp)
    return [rng.standard_normal((B, H, SL * cp, D)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [(_name(c), c[1], c[2], c[3], c[0], *_inputs(c[1])) for c in CASES]
    return tw.run_world(tw.cp_scenario, 4, tmp_path_factory.mktemp("cp"), cases)


def _jax_ring(path, cp, causal, dtype):
    """JAX's output and gradients of sum(out * w), and the ledger of the
    trace."""
    mesh = Mesh(np.asarray(jax.devices()[:cp]), ("context",))
    jdt = getattr(jnp, dtype)
    q, k, v, w = (jnp.asarray(a, jdt) for a in _inputs(cp))
    f = jax.shard_map(
        functools.partial(ring_attention, causal=causal, scale=SCALE,
                          axis_name="context",
                          impl="pallas" if path == "flash" else "jnp"),
        mesh=mesh, in_specs=(P(None, None, "context"),) * 3,
        out_specs=P(None, None, "context"), check_vma=False)
    jcomms.reset_comms_ledger()
    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    records = jcomms.comms_records()
    grads = vjp(w.astype(out.dtype))
    return out, grads, records


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_ring_attention_matches_jax(world, case):
    path, cp, causal, dtype = case
    out, grads, jrec = _jax_ring(*case)
    tol = TOL[(path, dtype)]
    name = _name(case)
    for rank in range(cp):  # the first context group: world ranks 0 .. cp-1
        o, g, odt, records = world[rank][name]
        assert odt == f"torch.{dtype}"
        sl = slice(rank * SL, (rank + 1) * SL)
        np.testing.assert_allclose(o, np.asarray(out, np.float32)[:, :, sl],
                                   atol=tol, rtol=tol, err_msg=f"{name} out")
        for got, ref, n in zip(g, grads, "qkv"):
            np.testing.assert_allclose(got, np.asarray(ref, np.float32)[:, :, sl],
                                       atol=tol, rtol=tol, err_msg=f"{name} d{n}")
        fwd = [r for r in records if r["site"] == "cp.ring_attention.kv"]
        bwd = [r for r in records if r["site"] == "cp.ring_attention.kv.bwd"]
        ref = [r for r in jrec if r["site"] == "cp.ring_attention.kv"]
        assert len(fwd) == len(ref) == 1 and len(bwd) == 1
        assert fwd[0]["kind"] == ref[0]["kind"] == "ppermute"
        assert fwd[0]["calls"] == ref[0]["calls"] * (cp - 1)
        assert fwd[0]["bytes"] // fwd[0]["calls"] == ref[0]["bytes"] // ref[0]["calls"]
        assert bwd[0]["calls"] == 2 * (cp - 1) and bwd[0]["bytes"] == fwd[0]["bytes"]
