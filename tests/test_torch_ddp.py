"""Port parity: data-parallel training (``parallel.distributed``,
``bucketing``, ``overlap``, cross-device ``sync_batch_norm`` and the
distributed ImageNet trainer) in gloo worlds of 2 and 4 processes against
the JAX package under ``shard_map`` over the same number of the 8 host
devices, on the same numpy inputs. Tolerances (PERF.md):

* ``reduce_gradients`` with each knob (average, sum, predivide, fp32,
  bucketed, compressed), on a grad tree and on the arenas of a
  ``PackedParams``: bitwise at W = 2, where each sum has two terms (one
  rounding, whichever order), compressed included; at W = 4 fp32 rtol 1e-6
  and bf16 within 2^-7 of the sum of |g| (a bf16 sum of four terms rounds
  up to three times, in an order each backend picks); compressed within
  ``compression_error_bound`` of the exact fp32 sum;
* ``overlap_backward`` (the identity Function on a tree, the
  post-accumulate hooks on a packed gradient arena) bitwise equal to the
  post-backward sweep at W = 2, and the compressed tree form, whose groups
  concatenate differently, within the compression bound;
* cross-device SyncBN forward and backward at the JAX module's own bounds
  (``tests/test_data_parallel.py``): y rtol/atol 1e-4, running mean 1e-4 /
  1e-5, running variance 1e-4, gradients 1e-3; with ``axis_index_groups``
  against JAX over each subgroup's devices;
* the tiny-ResNet trainer, 3 steps, at the bounds of
  ``tests/test_imagenet_trainer.py``'s distributed tests: O0 loss 1e-4,
  params and BN state 2e-4; O5 loss 2e-2.
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
from beforeholiday_tpu.ops.arena import PackedParams as JPacked  # noqa: E402
from beforeholiday_tpu.parallel import distributed as jdist  # noqa: E402
from beforeholiday_tpu.parallel.sync_batch_norm import (  # noqa: E402
    BatchNormParams as JBNParams,
    BatchNormState as JBNState,
    sync_batch_norm as jsync_bn,
)
from beforeholiday_tpu_torch.parallel import bucketing as tbucket  # noqa: E402

_shard_map = functools.partial(jax.shard_map, check_vma=False)
BF16_SUM_TOL = 2 ** -7
TRAINER_RUNS = [("O0", dict(sync_bn=True)),
                ("O5", dict(sync_bn=True)),
                ("O5", dict(sync_bn=True, bucket_bytes=4096, overlap_backward=True)),
                ("O5", dict(bucket_bytes=4096, compress=True))]


def _mesh(devs):
    return Mesh(np.asarray(devs), ("data",))


def _grad_spec(world):
    rng = np.random.default_rng(world)
    spec = {"w1": (rng.standard_normal((world, 5, 7)).astype(np.float32), "float32"),
            "w2": (rng.standard_normal((world, 33)).astype(np.float32), "float32"),
            "h": (rng.standard_normal((world, 4, 9)).astype(np.float32), "bfloat16")}
    spec["h"] = (np.asarray(jnp.asarray(spec["h"][0]).astype(jnp.bfloat16)
                            .astype(jnp.float32)), "bfloat16")
    arenas = [(rng.standard_normal((6, 11)).astype(np.float32),
               np.asarray(jnp.asarray(rng.standard_normal(40), jnp.bfloat16)
                          .astype(jnp.float32))) for _ in range(world)]
    return spec, arenas


def _sync_bn_inputs(world):
    rng = np.random.default_rng(10 + world)
    x = rng.standard_normal((world, 3, 6, 4, 4)).astype(np.float32) * 2 + 0.5
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return x, dy, rng.uniform(0.5, 1.5, 6).astype(np.float32), \
        rng.standard_normal(6).astype(np.float32)


def _trainer_inputs():
    p, s = jres.init(jax.random.PRNGKey(0), jres.tiny_test_config())
    weights = jax.tree.map(np.asarray, (p, s))
    return weights, list(jmain.synthetic_batches(16, 16, 10, 3, seed=7))


def _calls(world):
    spec, arenas = _grad_spec(world)
    calls = [("reduce_scenario", (spec, arenas)),
             ("sync_bn_scenario", (*_sync_bn_inputs(world),
                                   [[i for i in range(world) if i % 2 == j]
                                    for j in range(2)]))]
    if world == 2:
        rng = np.random.default_rng(3)
        w = [rng.standard_normal((8, 16)).astype(np.float32) * 0.3,
             rng.standard_normal((16, 4)).astype(np.float32) * 0.3,
             rng.standard_normal(4).astype(np.float32)]
        xs = rng.standard_normal((world, 5, 8)).astype(np.float32)
        calls += [("overlap_scenario", (w, xs)),
                  ("trainer_scenario", (*_trainer_inputs()[:1], TRAINER_RUNS,
                                        _trainer_inputs()[1]))]
    return calls


def _spawn(W, tmp_path_factory):
    return W, tw.run_world(tw.batch_scenario, W, tmp_path_factory.mktemp(f"ddp{W}"),
                           _calls(W))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@pytest.fixture(params=["world2", "world4"])
def world(request):
    return request.getfixturevalue(request.param)


# ------------------------------------------------------------ reduce_gradients


def _jax_reduce(W, spec, arenas, kw):
    names = sorted(spec)

    def f(*xs):
        tree = {k: x[0].astype(getattr(jnp, spec[k][1])) for k, x in zip(names, xs[:3])}
        red = jdist.reduce_gradients(tree, **kw)
        packed = JPacked.pack({"a": xs[3][0], "b": xs[4][0].astype(jnp.bfloat16)})
        pk = jdist.reduce_gradients(packed, **kw)
        return ({k: red[k].astype(jnp.float32) for k in names},
                [a.astype(jnp.float32) for a in pk.arenas])

    args = [jnp.asarray(spec[k][0]) for k in names]
    args += [jnp.asarray(np.stack([a[0] for a in arenas])),
             jnp.asarray(np.stack([a[1] for a in arenas]))]
    out = jax.jit(_shard_map(f, mesh=_mesh(jax.devices()[:W]),
                             in_specs=(P("data"),) * 5, out_specs=P()))(*args)
    return jax.tree.map(np.asarray, out)


def test_reduce_gradients_matches_jax(world):
    W, res = world
    spec, arenas = _grad_spec(W)
    from _torch_world import REDUCE_KNOBS

    for name, kw in REDUCE_KNOBS.items():
        jtree, jarenas = _jax_reduce(W, spec, arenas, kw)
        for rank, per_rank in enumerate(res):
            out = per_rank[0]
            got = {k: v for k, (v, _) in out[name].items()}
            packed = out[f"packed_{name}"]
            for k in spec:
                assert out[name][k][1] == f"torch.{spec[k][1]}", (name, k)
                _check(W, name, k, got[k], jtree[k], spec[k])
            # arenas by dtype name: the bf16 "b" first, then the fp32 "a"
            for i, (a, b) in enumerate(zip(packed, jarenas)):
                src = np.stack([r[1 - i].reshape(-1) for r in arenas])
                n = src.shape[1]
                _check(W, name, f"arena{i}", a[:n], b[:n],
                       (src, "bfloat16" if i == 0 else "float32"))
                assert not a[n:].any() and not b[n:].any()
    for per_rank in res:
        assert per_rank[0]["tripwire"] == (True, False)


def _check(W, name, what, got, ref, spec):
    stacked, dt = spec
    sum_abs = np.abs(stacked.reshape(W, -1)).sum(0).reshape(got.shape)
    if "compressed" in name:
        # the exact fp32 sum, scaled as the knob scales it
        exact = stacked.sum(0).reshape(got.shape) / (1 if name == "sum" else W)
        bound = tbucket.compression_error_bound(sum_abs / W) + (
            BF16_SUM_TOL * sum_abs / W if dt == "bfloat16" else 0)
        assert np.all(np.abs(got - exact) <= bound + 1e-7), (name, what)
        assert np.all(np.abs(ref - exact) <= bound + 1e-7), (name, what)
    elif W == 2:
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} {what}")
    elif dt == "bfloat16":
        scale = 1 if name == "sum" else W
        assert np.all(np.abs(got - ref) <= BF16_SUM_TOL * sum_abs / scale), (name, what)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7,
                                   err_msg=f"{name} {what}")


# ------------------------------------------------------------------- overlap


def test_overlap_backward_bitwise_equal_to_the_sweep(world2):
    W, res = world2
    sum_abs = [np.abs(a) + np.abs(b)
               for a, b in zip(res[0][2]["local"], res[1][2]["local"])]
    for per_rank in res:
        out = per_rank[2]
        for (name, packed), (sweep, hooked) in (
                (k, v) for k, v in out.items() if isinstance(k, tuple)):
            for i, (a, b) in enumerate(zip(sweep, hooked)):
                if name == "compressed" and not packed:
                    # the hooks' groups concatenate otherwise than the
                    # tree's; each within the wire bound of the exact mean
                    bound = 2 * tbucket.compression_error_bound(sum_abs[i] / 2)
                    assert np.all(np.abs(b - a) <= bound), (name, i)
                else:
                    np.testing.assert_array_equal(b, a, err_msg=f"{name} {packed}")
        for a, b in zip(out[("bucketed", True)][0], out["amp_packed"]):
            np.testing.assert_array_equal(b, a)
    # every rank holds the same reduced grads
    for key in res[0][2]:
        if key != "local":
            np.testing.assert_array_equal(
                np.concatenate([np.ravel(x) for x in _flat(res[0][2][key])]),
                np.concatenate([np.ravel(x) for x in _flat(res[1][2][key])]))


def _flat(v):
    if isinstance(v, list):
        return [y for x in v for y in _flat(x)]
    return [v]


# ------------------------------------------------------------------- SyncBN


def _jax_sync_bn(x, dy, scale, bias, devs):
    params = JBNParams(jnp.asarray(scale), jnp.asarray(bias))
    state = JBNState(jnp.zeros(6), jnp.ones(6))

    def f(xs, dys, params):
        def fwd(xs, params):
            return jsync_bn(xs[0], params, state, axis_name="data",
                                       fuse_relu=True)

        (y, new), vjp = jax.vjp(fwd, xs, params)
        dx, dp = vjp((dys[0], jax.tree.map(jnp.zeros_like, new)))
        return y[None], dx[0][None], dp.scale[None], dp.bias[None], new

    out = jax.jit(_shard_map(f, mesh=_mesh(devs),
                             in_specs=(P("data"), P("data"), P()),
                             out_specs=(P("data"),) * 4 + (P(),)))(
        jnp.asarray(x), jnp.asarray(dy), params)
    y, dx, ds, db, new = jax.tree.map(np.asarray, out)
    return dict(y=y, dx=dx, dscale=ds, dbias=db, mean=new.running_mean,
                var=new.running_var)


def _check_bn(got, ref, rank_in_ref):
    np.testing.assert_allclose(got["y"], ref["y"][rank_in_ref], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["mean"], ref["mean"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["var"], ref["var"], rtol=1e-4, atol=1e-4)
    for k in ("dx", "dscale", "dbias"):
        np.testing.assert_allclose(got[k], ref[k][rank_in_ref], rtol=1e-3, atol=1e-3,
                                   err_msg=k)


def test_sync_batch_norm_matches_jax(world):
    W, res = world
    x, dy, scale, bias = _sync_bn_inputs(W)
    ref = _jax_sync_bn(x, dy, scale, bias, jax.devices()[:W])
    for rank, per_rank in enumerate(res):
        _check_bn(per_rank[1]["all"], ref, rank)
        sites = {r["site"] for r in per_rank[1]["all"]["ledger"]}
        assert sites == {"sync_bn.stats", "sync_bn.backward"}
    for j in range(2):
        members = list(range(j, W, 2))
        ref = _jax_sync_bn(x[members], dy[members], scale, bias,
                           jax.devices()[:len(members)])
        for i, rank in enumerate(members):
            _check_bn(res[rank][1]["groups"], ref, i)


# ------------------------------------------------------------------- trainer


def _jax_trainer_run(level, kw, W, batches):
    tr = jmain.build_trainer(cfg=jres.tiny_test_config(), opt_level=level,
                             global_batch=16, num_classes=10, distributed=True,
                             devices=jax.devices()[:W], **kw)
    losses = []
    for images, labels in batches:
        losses.append(float(tr.step(*tr.shard_batch(images, labels), 0.05)["loss"]))
    params = tr.params.arenas if level == "O5" else jax.tree.leaves(tr.params)
    ev = float(tr.evaluate(*tr.shard_batch(*batches[0]))["loss"])
    return losses, [np.asarray(a, np.float32) for a in params], \
        [np.asarray(a, np.float32) for a in jax.tree.leaves(tr.bn_state)], ev


@pytest.mark.parametrize("run", range(len(TRAINER_RUNS)),
                         ids=[f"{lv}-{'-'.join(kw)}" for lv, kw in TRAINER_RUNS])
def test_distributed_trainer_matches_jax(world2, run):
    W, res = world2
    level, kw = TRAINER_RUNS[run]
    _, batches = _trainer_inputs()
    jl, jparams, jbn_state, jev = _jax_trainer_run(level, kw, W, batches)
    tol = 1e-4 if level == "O0" else 2e-2
    for per_rank in res:
        got = per_rank[3][run]
        losses = [m["loss"] for m in got["metrics"]]
        np.testing.assert_allclose(losses, jl, rtol=tol, atol=tol)
        np.testing.assert_allclose(got["eval"], jev, rtol=tol, atol=tol)
        assert not any(m["found_inf"] for m in got["metrics"])
        if level == "O0":
            for a, b in zip(got["params"], jparams):
                np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
            for a, b in zip(got["bn"], jbn_state):
                np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    # the ranks agree bitwise: reduced gradients, replicated state
    for a, b in zip(res[0][3][run]["params"], res[1][3][run]["params"]):
        np.testing.assert_array_equal(a, b)
