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
* the double-buffered engine (``overlap_p2p``: 1F1B at S = 2 and 4,
  interleaved at S = 2, V = 2, the embed/head decoupling) against JAX's
  overlap engine and against the port's sequential engine on the same data,
  at ``tests/test_overlap_engine.py``'s bounds (loss rtol 1e-5, grads rtol
  1e-4, atol 1e-5), its schedule report (``p2p_overlap``,
  ``phase_shift_ticks``, ``overlap_total_ticks``) equal to JAX's, and
  ``_overlap_tables`` equal to JAX's for several (M, S, V), with the
  invariants of ``tests/test_overlap_engine.py:587``;
* the encoder-decoder schedule (S = 4, split ranks 1, 2 and 3, the T5 toy
  of ``tests/test_pipeline_parallel.py``) against JAX's, at that file's
  bounds, and its report;
* the microbatch calculators, the p2p rings, and the errors: M not
  divisible by S when V > 1, an inputs/targets count mismatch (both
  engines), an unknown remat policy name, and the encoder-decoder schedule without a split rank or with one
  outside (0, S).
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
# tests/test_overlap_engine.py:525-587 and tests/test_pipeline_parallel.py's
# encoder-decoder bounds
OVERLAP_LOSS_RTOL, OVERLAP_GRAD_TOL = 1e-5, dict(rtol=1e-4, atol=1e-5)
SPLITS = (1, 2, 3)
# the remat policies the 1F1B engine runs under (tests/test_remat.py's)
REMAT = ("full", "dots_saveable", "save_boundaries")


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
    cases = {
        "1f1b_s4": (1, 4, dict(stacked=_stacked(4, 1), inputs=x, targets=y)),
        "1f1b_s2": (1, 2, dict(stacked=_stacked(2, 1), inputs=x, targets=y)),
        "interleaved_s2_v2": (1, 2, dict(stacked=inter, inputs=x, targets=y, V=2)),
        "embed_head_s4": (1, 4, dict(stacked=_stacked(4, 9), **eh)),
        "embed_head_interleaved": (1, 2, dict(stacked=inter_eh, V=2, **eh)),
        "tp2_pp2": (2, 2, dict(stacked=_stacked(2, 3), inputs=x, targets=y)),
    }
    for name in OVERLAP_OF:
        t, p, kw = cases[name]
        cases[f"{name}_overlap"] = (t, p, dict(kw, overlap=True))
    return cases


# the cases the double-buffered engine also runs
OVERLAP_OF = ("1f1b_s4", "1f1b_s2", "interleaved_s2_v2", "embed_head_s4")


def _t5_case(split):
    rng = np.random.default_rng(20 + split)
    S, m = 4, 6

    def mat(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    return dict(encdec=split, stacked={"w": mat(S, HIDDEN, HIDDEN),
                                       "b": np.zeros((S, HIDDEN), np.float32),
                                       "wm": mat(S, HIDDEN, HIDDEN)},
                ee={"we": mat(HIDDEN, HIDDEN)}, de={"we": mat(HIDDEN, HIDDEN)},
                hp={"wh": mat(HIDDEN, HIDDEN)},
                enc_in=mat(m, MICRO, HIDDEN), dec_in=mat(m, MICRO, HIDDEN),
                targets=mat(m, MICRO, HIDDEN), tensor_shape=(MICRO, HIDDEN))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [(name, t, p, kw) for name, (t, p, kw) in _cases().items()]
    cases += [(f"t5_split{k}", 1, 4, _t5_case(k)) for k in SPLITS]
    t, p, kw = _cases()["1f1b_s4"]
    cases += [(f"1f1b_s4_remat_{r}", t, p, dict(kw, remat=r)) for r in REMAT]
    return tw.run_world(tw.pp_scenario, WORLD, tmp_path_factory.mktemp("pp"), cases)


@functools.cache
def _jax_run(name):
    """JAX's engine on the case's data: (loss, grads stacked by pipe rank,
    or PipelineGrads parts) and the report; once a case."""
    tsize, S, kw = _cases()[name]
    V = kw.get("V")
    overlap = dict(overlap_p2p=kw.get("overlap", False))
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
                virtual_pipeline_model_parallel_size=V, **eh_, **overlap)
            stage_g = g.stage if has_eh else g
        else:
            sp = jax.tree.map(lambda v: v[0], st)
            loss, g = jpp.forward_backward_pipelining_without_interleaving(
                _stage, loss_fn, sp, inputs, targets, **eh_, **overlap)
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
    ref_report = jpp.last_schedule_report()
    ref_loss = float(ref[0])
    overlap = kw.get("overlap", False)
    loss_rtol, grad_tol = ((OVERLAP_LOSS_RTOL, OVERLAP_GRAD_TOL) if overlap
                           else (LOSS_RTOL, GRAD_TOL))
    for rank, s, tr in _ranks_of(name, tsize, S):
        loss, g, report = world[rank][0][name]
        np.testing.assert_allclose(loss, ref_loss, rtol=loss_rtol)
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
                                       **grad_tol)
        if "embed" in kw:
            np.testing.assert_allclose(g["embed"], np.asarray(ref[2]), **grad_tol)
            for k in ("w", "b"):
                np.testing.assert_allclose(g["head"][k], np.asarray(ref[3][k]),
                                           **grad_tol)
        if overlap:
            assert report == ref_report
            assert report["p2p_overlap"] is True and report["phase_shift_ticks"] > 0
            continue
        want = jpp.schedule_report(M if "embed" not in kw else 4, S, virtual_size=V,
                                   schedule="interleaved_1f1b" if V > 1 else "1f1b")
        assert report == want


@pytest.mark.parametrize("name", OVERLAP_OF)
def test_overlap_matches_the_sequential_engine(world, name):
    """The double-buffered engine against the port's sequential engine on
    the same data, at the overlap bounds."""
    for rank in range(WORLD):
        seq, ovl = world[rank][0][name], world[rank][0][f"{name}_overlap"]
        np.testing.assert_allclose(ovl[0], seq[0], rtol=OVERLAP_LOSS_RTOL)
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(ovl[1])[0],
                                     jax.tree_util.tree_flatten_with_path(seq[1])[0]):
            np.testing.assert_allclose(a, b, err_msg=f"{name} {path}", **OVERLAP_GRAD_TOL)
        assert ovl[2]["overlap_total_ticks"] == (ovl[2]["total_ticks"]
                                                 + ovl[2]["phase_shift_ticks"])


@pytest.mark.parametrize("m, s, v", [(4, 2, 1), (8, 4, 1), (16, 8, 1), (4, 2, 2),
                                     (8, 4, 2), (8, 2, 3), (6, 4, 1)])
def test_overlap_tables_match_jax(m, s, v):
    """The host tables equal JAX's, and hold tests/test_overlap_engine.py's
    invariants: distance-2 dependencies, one slot a device and tick, ring
    depths that no write clobbers before its read."""
    from collections import Counter

    from beforeholiday_tpu.transformer.pipeline_parallel.schedules import (
        _overlap_tables as jtables,
    )
    from beforeholiday_tpu_torch.transformer.pipeline_parallel.schedules import (
        _overlap_tables as ttables,
    )

    tab, ref = ttables(m, s, v), jtables(m, s, v)
    assert set(tab) == set(ref)
    for k, val in ref.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(tab[k], val, err_msg=k)
        else:
            assert tab[k] == val, k
    t_F, t_B, L = tab["t_F"], tab["t_B"], v * s
    assert len(t_F) == m * L and len(t_B) == m * L
    for (mm, l), t in t_F.items():
        assert l == 0 or t >= t_F[(mm, l - 1)] + 2
        assert l == 0 or 1 <= t - (t_F[(mm, l - 1)] + 1) <= tab["r_f"]
    for (mm, l), t in t_B.items():
        assert t - t_F[(mm, l)] < tab["r_act"]
        if l == L - 1:
            assert t >= t_F[(mm, l)] + 1
        else:
            assert t >= t_B[(mm, l + 1)] + 2
            assert 1 <= t - (t_B[(mm, l + 1)] + 1) <= tab["r_b"]
    assert max(Counter((l % s, t) for (_, l), t in t_F.items()).values()) == 1
    assert max(Counter((l % s, t) for (_, l), t in t_B.items()).values()) == 1
    if v == 1:
        assert tab["total_ticks"] == m + 4 * s - 3


def _jax_t5(split):
    """JAX's encoder-decoder schedule on the T5 toy."""
    kw = jax.tree.map(jnp.asarray, {k: v for k, v in _t5_case(split).items()
                                    if k not in ("encdec", "tensor_shape")})
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("pipe",))

    def stage(sp, h, mem, is_decoder):
        return jax.nn.gelu(h @ sp["w"] + sp["b"]) + h + is_decoder * jnp.tanh(mem @ sp["wm"])

    def body(st, ee, de, hp, enc_in, dec_in, targets):
        sp = jax.tree.map(lambda v: v[0], st)
        loss, g = jpp.forward_backward_pipelining_encoder_decoder(
            stage, _loss, sp, enc_in, dec_in, targets, split_rank=split,
            enc_embed_fn=lambda ep, x: x @ ep["we"], enc_embed_params=ee,
            dec_embed_fn=lambda ep, x: x @ ep["we"], dec_embed_params=de,
            head_fn=lambda p, h: h @ p["wh"], head_params=hp)
        return loss, jax.tree.map(lambda a: a[None], g.stage), g.enc_embed, \
            g.dec_embed, g.head

    f = _shard_map(body, mesh=mesh, in_specs=(P("pipe"),) + (P(),) * 6,
                   out_specs=(P(), P("pipe"), P(), P(), P()))
    out = jax.jit(f)(kw["stacked"], kw["ee"], kw["de"], kw["hp"], kw["enc_in"],
                     kw["dec_in"], kw["targets"])
    return out, jpp.last_schedule_report()


@pytest.mark.parametrize("split", SPLITS)
def test_encoder_decoder_matches_jax(world, split):
    (loss, gs, gee, gde, ghp), report = _jax_t5(split)
    for rank in range(WORLD):
        tl, tg, trep = world[rank][0][f"t5_split{split}"]
        np.testing.assert_allclose(tl, float(loss), rtol=OVERLAP_LOSS_RTOL)
        for k in ("w", "b", "wm"):
            np.testing.assert_allclose(tg["stage"][k], np.asarray(gs[k])[rank],
                                       err_msg=f"stage {k} rank {rank}", **OVERLAP_GRAD_TOL)
        for name, ref in (("enc_embed", gee), ("dec_embed", gde), ("head", ghp)):
            for k, v in ref.items():
                np.testing.assert_allclose(tg[name][k], np.asarray(v), err_msg=name,
                                           **OVERLAP_GRAD_TOL)
        assert trep == report and trep["split_rank"] == split


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
    # remat (slice 18): the stage recomputed in the backward, bitwise
    rl, rg = tpp.forward_backward_no_pipelining(
        lambda sp, a: tw._toy_stage({k: v[0] for k, v in sp.items()}, a),
        tw._toy_loss, {k: torch.from_numpy(v) for k, v in stacked.items()},
        torch.from_numpy(x), torch.from_numpy(y), remat_policy="full")
    assert torch.equal(rl, tl) and all(torch.equal(rg[k], tg[k]) for k in ("w", "b"))


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
    assert errors[2].startswith("ValueError") and "mismatch" in errors[2]
    assert errors[3].startswith("ValueError") and "unknown remat policy" in errors[3]
    assert errors[4].startswith("ValueError") and "split_rank" in errors[4]
    assert errors[5].startswith("ValueError") and "0 < split_rank" in errors[5]


@pytest.mark.parametrize("policy", REMAT)
def test_1f1b_remat_matches_jax(world, policy):
    """Per-stage remat in the 1F1B engine (S 4) against JAX's 1F1B at the
    bounds of ``tests/test_remat.py:232`` (which holds JAX's remat 1F1B to
    its plain run, the reference here, shared with the plain case), and
    bitwise the port's no-remat run of the same case."""
    jl, jg = _jax_run("1f1b_s4")
    for rank in range(WORLD):
        loss, g, _ = world[rank][0][f"1f1b_s4_remat_{policy}"]
        base_loss, base_g, _ = world[rank][0]["1f1b_s4"]
        np.testing.assert_allclose(loss, float(jl), rtol=LOSS_RTOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], np.asarray(jg[k])[rank], **GRAD_TOL)
            np.testing.assert_array_equal(g[k], base_g[k])
        assert loss == base_loss
