"""Port parity: pipeline parallelism (``transformer.pipeline_parallel``) in
one gloo world of 4 processes, against the JAX package's engine under
``shard_map`` on the same numpy stage weights (the toy stack of
``tests/test_pipeline_parallel.py:44-93``).

* 1F1B at S = 2 and 4, interleaved at S = 2, V = 2, the embed/head
  decoupling with ``PipelineGrads`` (1F1B at S = 4, interleaved at S = 2,
  V = 2) and TP 2 x PP 2 with ``column_parallel_linear`` inside the stage:
  loss rtol 1e-6, grads rtol 1e-5, atol 1e-6. The tick table is JAX's, so
  every gradient sums its terms in JAX's order;
* ``schedule_report``, ``phase_counts``, ``activation_ring_depth`` and
  ``analytic_bubble_fraction`` equal to JAX's, exactly, for several (M, S,
  V); the run's ``last_schedule_report`` too;
* the microbatch calculators, the p2p rings, and the errors: M not
  divisible by S when V > 1, an inputs/targets count mismatch, and the
  pieces not ported yet (``overlap_p2p``, remat policies, the
  encoder-decoder schedule) raising ``NotImplementedError``.
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

from beforeholiday_tpu.transformer import pipeline_parallel as jpp  # noqa: E402
from beforeholiday_tpu.transformer import tensor_parallel as jtp  # noqa: E402
from beforeholiday_tpu_torch.transformer import pipeline_parallel as tpp  # noqa: E402

HIDDEN, MICRO, M, VOCAB = 8, 4, 6, 12
WORLD = 4
_shard_map = functools.partial(jax.shard_map, check_vma=False)
LOSS_RTOL, GRAD_TOL = 1e-6, dict(rtol=1e-5, atol=1e-6)


def _stage(sp, x):
    return jax.nn.gelu(x @ sp["w"] + sp["b"]) + x


def _loss(y, tgt):
    return jnp.mean((y - tgt) ** 2)


def _ce(logits, labels):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))


def _stacked(n, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n, HIDDEN, HIDDEN)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((n, HIDDEN)) * 0.1).astype(np.float32)}


def _reorder(stacked, S, V):
    perm = np.array([[v * S + s for v in range(V)] for s in range(S)]).ravel()
    return {k: v[perm] for k, v in stacked.items()}, perm


def _data(seed=0, m=M):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, MICRO, HIDDEN)).astype(np.float32),
            rng.standard_normal((m, MICRO, HIDDEN)).astype(np.float32))


def _embed_head(seed=8, m=4):
    rng = np.random.default_rng(seed)
    return dict(
        embed=(rng.standard_normal((VOCAB, HIDDEN)) * 0.3).astype(np.float32),
        head={"w": (rng.standard_normal((HIDDEN, VOCAB)) * 0.3).astype(np.float32),
              "b": np.zeros((VOCAB,), np.float32)},
        inputs=rng.integers(0, VOCAB, (m, MICRO)).astype(np.int32),
        targets=rng.integers(0, VOCAB, (m, MICRO)).astype(np.int32),
        tensor_shape=(MICRO, HIDDEN))


def _cases():
    """name -> (tp, pp, kw), every case's data made here."""
    x, y = _data()
    inter, _ = _reorder(_stacked(4, 2), 2, 2)
    eh = _embed_head()
    inter_eh, _ = _reorder(_stacked(4, 9), 2, 2)
    return {
        "1f1b_s4": (1, 4, dict(stacked=_stacked(4, 1), inputs=x, targets=y)),
        "1f1b_s2": (1, 2, dict(stacked=_stacked(2, 1), inputs=x, targets=y)),
        "interleaved_s2_v2": (1, 2, dict(stacked=inter, inputs=x, targets=y, V=2)),
        "embed_head_s4": (1, 4, dict(stacked=_stacked(4, 9), **eh)),
        "embed_head_interleaved": (1, 2, dict(stacked=inter_eh, V=2, **eh)),
        "tp2_pp2": (2, 2, dict(stacked=_stacked(2, 3), inputs=x, targets=y)),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [(name, t, p, kw) for name, (t, p, kw) in _cases().items()]
    return tw.run_world(tw.pp_scenario, WORLD, tmp_path_factory.mktemp("pp"), cases)


def _jax_run(name):
    """JAX's engine on the case's data: (loss, grads stacked by pipe rank,
    or PipelineGrads parts) and the report."""
    tsize, S, kw = _cases()[name]
    V = kw.get("V")
    stacked = jax.tree.map(jnp.asarray, kw["stacked"])
    args = (jnp.asarray(kw["inputs"]), jnp.asarray(kw["targets"]))
    has_eh = "embed" in kw
    eh = dict(embed_fn=lambda ep, t: ep[t], embed_params=jnp.asarray(kw["embed"]),
              head_fn=lambda hp, h: h @ hp["w"] + hp["b"],
              head_params=jax.tree.map(jnp.asarray, kw["head"])) if has_eh else {}
    loss_fn = _ce if has_eh else _loss
    if tsize > 1:
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(S, tsize), ("pipe", "tensor"))

        def stage(sp, x):
            h = jtp.column_parallel_linear(x, sp["w"], sp["b"], gather_output=True,
                                           axis_name="tensor")
            return jax.nn.gelu(h) + x

        def body(st, inputs, targets):
            tr = jax.lax.axis_index("tensor")
            sp = jax.tree.map(lambda v: v[0], st)
            half = HIDDEN // tsize
            sp = {"w": jax.lax.dynamic_slice_in_dim(sp["w"], tr * half, half, axis=1),
                  "b": jax.lax.dynamic_slice_in_dim(sp["b"], tr * half, half)}
            loss, g = jpp.forward_backward_pipelining_without_interleaving(
                stage, loss_fn, sp, inputs, targets)
            return loss, jax.tree.map(lambda a: a[None, None], g)

        f = _shard_map(body, mesh=mesh, in_specs=(P("pipe"), P(), P()),
                       out_specs=(P(), P("pipe", "tensor")))
        return jax.jit(f)(stacked, *args)
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("pipe",))

    def body(st, inputs, targets, ep=None, hp=None):
        if has_eh:
            eh_ = {**eh, "embed_params": ep, "head_params": hp}
        else:
            eh_ = {}
        if V is not None:
            loss, g = jpp.forward_backward_pipelining_with_interleaving(
                _stage, loss_fn, st, inputs, targets,
                virtual_pipeline_model_parallel_size=V, **eh_)
            stage_g = g.stage if has_eh else g
        else:
            sp = jax.tree.map(lambda v: v[0], st)
            loss, g = jpp.forward_backward_pipelining_without_interleaving(
                _stage, loss_fn, sp, inputs, targets, **eh_)
            stage_g = jax.tree.map(lambda a: a[None], g.stage if has_eh else g)
        if has_eh:
            return loss, stage_g, g.embed, g.head
        return loss, stage_g

    if has_eh:
        f = _shard_map(body, mesh=mesh, in_specs=(P("pipe"), P(), P(), P(), P()),
                       out_specs=(P(), P("pipe"), P(), P()))
        return jax.jit(f)(stacked, *args, eh["embed_params"], eh["head_params"])
    f = _shard_map(body, mesh=mesh, in_specs=(P("pipe"), P(), P()),
                   out_specs=(P(), P("pipe")))
    return jax.jit(f)(stacked, *args)


def _ranks_of(name, tsize, S):
    """(global rank, pipe rank, tensor rank) of the ranks whose pipe group
    runs the case: the world is laid out (pipe, data, tensor)."""
    dp = WORLD // (tsize * S)
    return [(r, r // (dp * tsize), r % tsize) for r in range(WORLD)]


@pytest.mark.parametrize("name", sorted(_cases()))
def test_schedule_matches_jax(world, name):
    tsize, S, kw = _cases()[name]
    V = kw.get("V") or 1
    ref = _jax_run(name)
    ref_loss = float(ref[0])
    for rank, s, tr in _ranks_of(name, tsize, S):
        loss, g, report = world[rank][0][name]
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
        stage = g["stage"] if "embed" in kw else g
        for k in ("w", "b"):
            want = np.asarray(ref[1][k])
            if tsize > 1:
                want = want[s, tr]
            elif V > 1:
                want = want[s * V:(s + 1) * V]
            else:
                want = want[s]
            np.testing.assert_allclose(stage[k], want, err_msg=f"{name} {k} rank {rank}",
                                       **GRAD_TOL)
        if "embed" in kw:
            np.testing.assert_allclose(g["embed"], np.asarray(ref[2]), **GRAD_TOL)
            for k in ("w", "b"):
                np.testing.assert_allclose(g["head"][k], np.asarray(ref[3][k]),
                                           **GRAD_TOL)
        want = jpp.schedule_report(M if "embed" not in kw else 4, S, virtual_size=V,
                                   schedule="interleaved_1f1b" if V > 1 else "1f1b")
        assert report == want


@pytest.mark.parametrize("m, s, v", [(1, 1, 1), (6, 2, 1), (8, 4, 1), (4, 2, 2),
                                     (12, 4, 3), (16, 8, 2), (3, 4, 1)])
def test_reports_match_jax(m, s, v):
    assert tpp.schedule_report(m, s, virtual_size=v, extra={"x": 1}) == \
        jpp.schedule_report(m, s, virtual_size=v, extra={"x": 1})
    assert tpp.activation_ring_depth(v, s) == jpp.activation_ring_depth(v, s)
    assert tpp.analytic_bubble_fraction(m, s, v) == jpp.analytic_bubble_fraction(m, s, v)
    for r in range(s):
        assert tpp.phase_counts(m, s, r, v) == jpp.phase_counts(m, s, r, v)


def test_get_forward_backward_func():
    assert tpp.get_forward_backward_func(None, 1) is tpp.forward_backward_no_pipelining
    assert (tpp.get_forward_backward_func(None, 2)
            is tpp.forward_backward_pipelining_without_interleaving)
    assert (tpp.get_forward_backward_func(2, 4)
            is tpp.forward_backward_pipelining_with_interleaving)


@pytest.mark.parametrize("args", [(64, 4, 2, None), (48, 4, 3, None),
                                  (64, 4, 2, [16, 8, 1000]), (96, 2, 4, [8, 8, 500])])
def test_microbatch_calculators_match_jax(args):
    gb, mb, dp, ramp = args
    a = tpp.build_num_microbatches_calculator(gb, mb, dp, ramp)
    b = jpp.build_num_microbatches_calculator(gb, mb, dp, ramp)
    for consumed in (0, 10, 100, 250, 499, 500, 10_000):
        a.update(consumed, False)
        b.update(consumed, False)
        assert (a.get(), a.get_current_global_batch_size()) == \
            (b.get(), b.get_current_global_batch_size())


def test_microbatch_calculator_errors():
    with pytest.raises(ValueError, match="not divisible"):
        tpp.build_num_microbatches_calculator(10, 4, 2)
    with pytest.raises(ValueError, match="start_size"):
        tpp.build_num_microbatches_calculator(64, 4, 2, [1, 2])


def test_no_pipelining_matches_jax():
    """Gradient accumulation over M microbatches, in one process."""
    import torch

    stacked = _stacked(1, 4)
    x, y = _data(5)
    jl, jg = jpp.forward_backward_no_pipelining(
        lambda sp, a: _stage(jax.tree.map(lambda v: v[0], sp), a), _loss,
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(x), jnp.asarray(y))
    tl, tg = tpp.forward_backward_no_pipelining(
        lambda sp, a: tw._toy_stage({k: v[0] for k, v in sp.items()}, a),
        tw._toy_loss, {k: torch.from_numpy(v) for k, v in stacked.items()},
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)
    with pytest.raises(NotImplementedError, match="A13"):
        tpp.forward_backward_no_pipelining(tw._toy_stage, tw._toy_loss, {}, torch.zeros(1),
                                           torch.zeros(1), remat_policy="full")


def test_rings(world):
    for rank in range(WORLD):
        fwd, bwd, fwd2 = world[rank][0]["rings"]
        np.testing.assert_array_equal(fwd, np.full(2, (rank - 1) % WORLD))
        np.testing.assert_array_equal(fwd2, np.full(2, (rank - 1) % WORLD))
        np.testing.assert_array_equal(bwd, np.full(2, 10 + (rank + 1) % WORLD))


def test_errors(world):
    errors = world[0][1]
    assert errors[0].startswith("ValueError") and "divisible" in errors[0]
    assert errors[1].startswith("ValueError") and "mismatch" in errors[1]
    for e in errors[2:]:
        assert e.startswith("NotImplementedError") and "ROADMAP" in e
    assert "A15" in errors[2] and "A13" in errors[3] and "A15" in errors[4]
