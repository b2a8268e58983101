"""Port parity: expert-parallel Mixture-of-Experts over ``torch.distributed``
— the differentiable ``all_to_all``, ``moe_layer`` on an expert group, with
a tensor group inside the experts, over the two-level ``("slice",
"intra")`` pair, and the ported ``moe_gpt`` example — against the port's
one-process layer and the JAX package.

One spawned gloo world of 4 (``tests/_torch_world.py`` ``moe_scenario``)
holds every case, each on its own mesh. The JAX side runs under
``shard_map`` over 4 host devices (the exchange) or on one device (the
per-group references). Against JAX every comparison is at a tolerance: the
JAX package's own expert-parallel bitwise tests fail on this CPU.

* The exchange: forward and backward bitwise against ``lax.all_to_all``
  (pure data movement); its ledger books the forward at the site and the
  backward at ``site + ".bwd"``.
* EP 4 and EP 2 x TP 2 (capacity factor 8, nothing drops): each group's
  output, aux scalars and the gradients of its router and tokens bitwise
  the same group computed in one process with every expert local (the
  tensor split emulated there, ``emulate_tensor=2``); the expert-weight
  gradients, summed over the groups, within fp32 reordering; the outputs
  against JAX's ``dense_oracle`` (EP) and ``moe_layer(..., emulate_tensor=2)``
  (EP x TP) at rtol 1e-5, atol 1e-6 of the largest value.
* Hierarchical over a 2 x 2 two-level mesh: bitwise the joint exchange,
  forward and backward; the ledger books the slice stage on DCN and the
  intra stage on ICI, each the full (E, C, D) payload a call, as the JAX
  test counts them (``tests/test_moe.py:362-410``).
* The example at 2 x 2 and 1 x 4 (data x expert), 2 steps: the first
  step's reduced gradients, the group-mean losses and every parameter
  against JAX's GPT run group by group with all experts local, the losses
  averaged, grads by ``jax.grad`` and JAX's FusedAdam; its ledger's
  dispatch and combine calls and bytes.
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

from beforeholiday_tpu import moe as jm  # noqa: E402
from beforeholiday_tpu.optimizers import FusedAdam as JFusedAdam  # noqa: E402
from beforeholiday_tpu.testing import gpt as jgpt  # noqa: E402
from beforeholiday_tpu_torch.examples.simple.distributed import moe_gpt  # noqa: E402

_shard_map = getattr(jax, "shard_map", None)
_CHECK_KW = "check_vma"
if _shard_map is None:
    from jax.experimental.shard_map import shard_map as _shard_map

    _CHECK_KW = "check_rep"

W = 4
E, D, F, T = 8, 32, 64, 16
CFG = dict(n_experts=E, top_k=2, capacity_factor=8.0)
EX_STEPS, EX_BATCH = 2, 2


def _smap(fn, mesh, in_specs, out_specs):
    return _shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      **{_CHECK_KW: False})


def _close(got, ref, rtol=1e-5, atol=1e-6):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * np.abs(ref).max())


def _layer_inputs(seed, groups):
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, jm.init_experts(jax.random.PRNGKey(seed), E, D, F))
    return (params, (rng.randn(D, E) * 0.1).astype(np.float32),
            rng.randn(groups * T, D).astype(np.float32))


def _a2a_inputs():
    rng = np.random.RandomState(11)
    shapes = {"fwd": ((W, E, 3, 5), (W, E // W, W * 3, 5)),
              "inv": ((W, E // W, W * 3, 5), (W, E, 3, 5))}
    x = {k: rng.randn(*s[0]).astype(np.float32) for k, s in shapes.items()}
    ct = {k: rng.randn(*s[1]).astype(np.float32) for k, s in shapes.items()}
    return x, ct


def _example_spec(dp, ep):
    args = moe_gpt.parse_args(["--world", str(dp * ep), "--expert-parallel", str(ep),
                               "--steps", str(EX_STEPS), "--batch", str(EX_BATCH)])
    return moe_gpt.spec_from_args(args)


@pytest.fixture(scope="module")
def example_ref():
    """The JAX package's GPT run group by group with all experts local, the
    groups' losses averaged, ``jax.grad`` and JAX's FusedAdam: the params,
    tokens, per-step losses and final params the example is held to."""
    spec = _example_spec(1, W)
    cfg = jgpt.GPTConfig(**spec["model"])
    params = jgpt.init(jax.random.PRNGKey(0), cfg)
    tok, tgt = jgpt.synthetic_batch(jax.random.PRNGKey(1), cfg, W * EX_BATCH)
    b = EX_BATCH

    def loss(p):
        return sum(jgpt.loss_and_aux(p, tok[g * b:(g + 1) * b], tgt[g * b:(g + 1) * b],
                                     cfg)[0] for g in range(W)) / W

    opt = JFusedAdam(lr=spec["lr"], impl="jnp")
    vg = jax.jit(jax.value_and_grad(loss))
    p, o, losses, first = params, opt.init(params), [], None
    for _ in range(EX_STEPS):
        val, g = vg(p)
        first = jax.tree.map(np.asarray, g) if first is None else first
        p, o = opt.step(p, g, o)
        losses.append(float(val))
    return dict(params=jax.tree.map(np.asarray, params), tokens=np.asarray(tok),
                losses=losses, first_grads=first, final=jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def world(tmp_path_factory, example_ref):
    x_a2a, ct_a2a = _a2a_inputs()
    cases = {"a2a": dict(kind="a2a", x=x_a2a, ct=ct_a2a)}
    for name, seed, kw in (("ep", 3, dict(ep=W)), ("ep_tp", 4, dict(ep=2, tp=2)),
                           ("hier", 5, {})):
        groups = W if name != "ep_tp" else 2
        params, w, x = _layer_inputs(seed, groups)
        cases[name] = dict(kind=name, cfg=CFG, params=params, w=w, x=x, T=T, **kw)
    for dp, ep in ((2, 2), (1, 4)):
        spec = dict(_example_spec(dp, ep), params=example_ref["params"],
                    tokens=example_ref["tokens"])
        cases[f"example_{dp}x{ep}"] = dict(kind="example", spec=spec)
    res = tw.run_world(tw.moe_scenario, W, tmp_path_factory.mktemp("moe"), cases)
    return cases, res


def test_all_to_all_matches_jax(world, devices8):
    """The tiled exchange (split 0, concat 1) and its inverse (1, 0),
    forward and backward, bitwise ``lax.all_to_all`` under ``shard_map``;
    one record at the site and one at ``.bwd``, each this rank's operand."""
    cases, res = world
    mesh = Mesh(np.asarray(devices8[:W]), ("expert",))
    for name, (s, c) in (("fwd", (0, 1)), ("inv", (1, 0))):
        x, ct = cases["a2a"]["x"][name], cases["a2a"]["ct"][name]
        f = _smap(lambda a, s=s, c=c: jax.lax.all_to_all(a, "expert", s, c, tiled=True),
                  mesh, (P("expert"),), P("expert"))
        y, vjp = jax.vjp(f, jnp.asarray(x.reshape(-1, *x.shape[2:])))
        (dx,) = vjp(jnp.asarray(ct.reshape(-1, *ct.shape[2:])))
        y, dx = np.asarray(y).reshape(ct.shape), np.asarray(dx).reshape(x.shape)
        for r in range(W):
            got_y, got_dx, records = res[r]["a2a"][name]
            np.testing.assert_array_equal(got_y, y[r])
            np.testing.assert_array_equal(got_dx, dx[r])
            sites = {rec["site"]: rec for rec in records}
            assert set(sites) == {"t.a2a", "t.a2a.bwd"}
            assert sites["t.a2a"]["bytes"] == x[r].nbytes
            assert sites["t.a2a.bwd"]["bytes"] == ct[r].nbytes
            assert sites["t.a2a"]["calls"] == sites["t.a2a.bwd"]["calls"] == 1


def _check_against_local(res, case, ranks_of_group):
    """Each group's distributed result against the same group computed with
    every expert local: forward, aux, router and token grads bitwise; the
    expert-weight grads, summed over the groups, within fp32 reordering
    (rtol 1e-5, atol 1e-6 of the largest)."""
    for g, ranks in ranks_of_group.items():
        for r in ranks:
            d, loc = res[r][case]["dist"], res[r][case]["local"]
            np.testing.assert_array_equal(d["y"], loc["y"])
            assert d["aux"] == loc["aux"]
            np.testing.assert_array_equal(d["dx"], loc["dx"])
            np.testing.assert_array_equal(d["dw"], loc["dw"])
    return {k: sum(res[ranks[0]][case]["local"]["dp"][k]
                   for ranks in ranks_of_group.values())
            for k in res[0][case]["local"]["dp"]}


def test_expert_parallel_layer(world):
    """EP 4: every rank's group against one process and JAX's dense oracle;
    each rank's expert shard of the weight grads is the sum over the groups;
    the ledger's dispatch and combine each one (E, C, D) payload a call."""
    cases, res = world
    c = cases["ep"]
    want = _check_against_local(res, "ep", {g: [g] for g in range(W)})
    cfg = jm.MoEConfig(**CFG)
    jp = jax.tree.map(jnp.asarray, c["params"])
    for g in range(W):
        ref, _ = jax.jit(lambda xx: jm.dense_oracle(xx, jnp.asarray(c["w"]), jp, cfg))(
            jnp.asarray(c["x"][g * T:(g + 1) * T]))
        _close(res[g]["ep"]["dist"]["y"], ref)
        n = E // W
        for k, v in want.items():
            _close(res[g]["ep"]["dist"]["dp"][k], v[g * n:(g + 1) * n])
        payload = E * cfg.capacity(T) * D * 4
        rows = {r["site"]: r for r in res[g]["ep"]["dist"]["ledger"]}
        assert set(rows) == {"moe.dispatch", "moe.combine", "moe.dispatch.bwd",
                             "moe.combine.bwd"}
        assert all(r["calls"] == 1 and r["bytes"] == payload for r in rows.values())


def test_expert_and_tensor_parallel_layer(world):
    """EP 2 x TP 2: both tensor ranks of an expert rank route its group; the
    output bitwise the one-process ``emulate_tensor=2`` layer and within
    rtol 1e-5 of JAX's; each rank's (expert, d_ff) shard of the weight
    grads the sum over the groups; the row-parallel psum booked once a
    call and the input's backward psum at ``moe.experts.column_parallel.bwd``."""
    cases, res = world
    c = cases["ep_tp"]
    groups = {e: [2 * e, 2 * e + 1] for e in range(2)}
    want = _check_against_local(res, "ep_tp", groups)
    cfg = jm.MoEConfig(**CFG)
    jp = jax.tree.map(jnp.asarray, c["params"])
    for e, ranks in groups.items():
        ref, _ = jax.jit(lambda xx: jm.moe_layer(
            xx, jnp.asarray(c["w"]), jp, cfg, capacity=cfg.capacity(T),
            emulate_tensor=2))(jnp.asarray(c["x"][e * T:(e + 1) * T]))
        for r in ranks:
            out = res[r]["ep_tp"]
            _close(out["dist"]["y"], ref)
            t, n, f = out["tensor_rank"], E // 2, F // 2
            cuts = {"wi": (slice(e * n, (e + 1) * n), slice(None), slice(t * f, (t + 1) * f)),
                    "bi": (slice(e * n, (e + 1) * n), slice(t * f, (t + 1) * f)),
                    "wo": (slice(e * n, (e + 1) * n), slice(t * f, (t + 1) * f)),
                    "bo": (slice(e * n, (e + 1) * n),)}
            for k, v in want.items():
                _close(out["dist"]["dp"][k], v[cuts[k]])
            sites = {x["site"] for x in out["dist"]["ledger"]}
            assert {"moe.experts.row_parallel", "moe.experts.column_parallel.bwd",
                    "moe.dispatch", "moe.combine"} <= sites


def test_hierarchical_dispatch(world):
    """Over (slice, intra) on 2 x 2: the two-stage exchange bitwise the
    joint one, forward and backward, and the groups against JAX's dense
    oracle; the ledger books each stage's full payload on its tier, and the
    joint exchange (its axis crosses the slice tier) on DCN."""
    cases, res = world
    c = cases["hier"]
    cfg = jm.MoEConfig(**CFG)
    jp = jax.tree.map(jnp.asarray, c["params"])
    payload = E * cfg.capacity(T) * D * 4
    for r in range(W):
        out = res[r]["hier"]
        j, h = out["joint"], out["hier"]
        for k in ("y", "dx", "dw"):
            np.testing.assert_array_equal(h[k], j[k])
        for k in h["dp"]:
            np.testing.assert_array_equal(h["dp"][k], j["dp"][k])
        g = out["group"]
        ref, _ = jax.jit(lambda xx: jm.dense_oracle(xx, jnp.asarray(c["w"]), jp, cfg))(
            jnp.asarray(c["x"][g * T:(g + 1) * T]))
        _close(h["y"], ref)
        rows = {x["site"]: x for x in h["ledger"]}
        for site, tier in (("moe.dispatch.slice", "dcn"), ("moe.combine.slice", "dcn"),
                           ("moe.dispatch.intra", "ici"), ("moe.combine.intra", "ici")):
            assert rows[site]["tier"] == tier and rows[site]["bytes"] == payload, site
            assert rows[site + ".bwd"]["tier"] == tier
        joint = {x["site"]: x for x in j["ledger"]}
        assert joint["moe.dispatch"]["tier"] == "dcn"
        assert joint["moe.dispatch"]["bytes"] == payload


def _rel_l2(got, ref):
    """``|got - ref| / |ref|`` in L2 (``|got|`` where ``ref`` is all zero)."""
    d = float(np.linalg.norm((np.asarray(got, np.float64) - ref).ravel()))
    n = float(np.linalg.norm(np.asarray(ref, np.float64).ravel()))
    return d / n if n else d


@pytest.mark.parametrize("carve", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_example_matches_jax_group_mean(world, example_ref, carve):
    """The example's step (the reduction of its module docstring) gives the
    gradient of the mean of the groups' losses. Each rank's reduced
    gradients of the first step (the expert stack assembled from the expert
    ranks; replicated leaves, and an expert rank's shard, bitwise equal on
    every rank that holds them) against ``jax.grad`` of JAX's group mean at
    relative L2 1e-4 a leaf (fp32, only the summation orders differ): the
    JAX example's ``pmean`` over the expert group, a missing ``1 / ep`` or a
    flipped sign is off by 0.5 or more. The group-mean loss each step rtol
    1e-5; every parameter after the steps within 2 lr a step plus 1e-6 (a
    gradient near 0 that flips sign moves Adam's step by 2 lr); the ledger:
    each MoE layer books one dispatch and one combine a step, (E, C, D) fp32
    each."""
    _, res = world
    dp, ep = carve
    ranks = [r[f"example_{dp}x{ep}"] for r in res]
    losses = np.mean([r["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(losses, example_ref["losses"], rtol=1e-5)
    from beforeholiday_tpu_torch.ops.arena import tree_paths
    from beforeholiday_tpu_torch.testing import gpt as tgpt

    spec = _example_spec(dp, ep)
    paths = tree_paths(tgpt.params_from_numpy(example_ref["params"], device="cpu"))

    def assembled(key, i, path):
        if "experts" in path:
            by_e = {}
            for r in ranks:
                shard = by_e.setdefault(r["expert_rank"], r[key][i])
                assert np.array_equal(shard, r[key][i]), (key, path)
            return np.concatenate([by_e[e] for e in range(ep)], axis=1)
        got = ranks[0][key][i]
        assert all(np.array_equal(got, r[key][i]) for r in ranks), (key, path)
        return got

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    rel = {path: _rel_l2(assembled("first_grads", i, path),
                         leaf(example_ref["first_grads"], path))
           for i, path in enumerate(paths)}
    assert max(rel.values()) <= 1e-4, rel
    tol = 2 * spec["lr"] * EX_STEPS + 1e-6
    for i, path in enumerate(paths):
        np.testing.assert_allclose(assembled("params", i, path),
                                   leaf(example_ref["final"], path), rtol=0, atol=tol,
                                   err_msg=str(path))
    cfg = tgpt.GPTConfig(**spec["model"])
    C = cfg.moe_cfg().capacity(EX_BATCH * cfg.seq_len)
    payload = cfg.moe_experts * C * cfg.d_model * 4
    for r in ranks:
        rows = {x["site"]: x for x in r["ledger"]}
        for site in ("moe.dispatch", "moe.combine"):
            assert rows[site]["calls"] == cfg.moe_groups * EX_STEPS
            assert rows[site]["bytes"] == payload * cfg.moe_groups * EX_STEPS
    assert losses[-1] < losses[0]
