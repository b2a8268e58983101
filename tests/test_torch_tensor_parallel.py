"""Port parity: tensor and sequence parallelism
(``transformer.tensor_parallel``, ``transformer.layers``,
``transformer.amp_grad_scaler``) in one gloo world of 4 processes, against
the JAX package's functions under ``shard_map`` over the same number of the
8 host devices.

* every mapping's forward and backward (copy/reduce, the last-dim
  scatter/gather, the sequence-parallel scatter/gather with and without the
  tensor-parallel gradient, the reduce-scatter) at W = 4 and W = 2, fp32:
  rtol/atol 1e-5;
* ``column_parallel_linear`` (plain, ``gather_output``, sequence parallel),
  ``row_parallel_linear`` (plain, input not parallel, sequence parallel),
  ``vocab_parallel_embedding`` and ``vocab_parallel_cross_entropy``
  (smoothing 0 and 0.1, ``save_softmax`` both ways), outputs and gradients:
  fp32 at W = 4 and 2 (rtol/atol 1e-5), bf16 at W = 2 (rtol one ulp,
  2^-7, and an atol of two ulps of the largest value: XLA's CPU reduction
  of a bias gradient over the tokens rounds in bf16 at more places, and
  may keep a product's fp32 sum through its bias add);
* ``sp_fused_layer_norm``'s parameter gradients come back whole
  (``tests/test_transformer_extras.py:127``);
* one rank's overflow reaches its whole tensor group through
  ``reduce_found_inf`` and ``GradScaler``, and no other group;
* ``broadcast_data`` (forced: tensor rank 0's values), the memory buffers;
* the chunked gathers and reduce-scatters (``set_collective_chunk_bytes``)
  bitwise the single collectives.
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

from beforeholiday_tpu.transformer import tensor_parallel as jtp  # noqa: E402
from beforeholiday_tpu.transformer.layers import sp_fused_layer_norm as jsp_ln  # noqa: E402

WORLD = 4
SIZES = (4, 2)
T, DIN, DOUT, HID, VOCAB, N = 8, 8, 12, 6, 16, 6
_shard_map = functools.partial(jax.shard_map, check_vma=False)
F32 = dict(rtol=1e-5, atol=1e-5)

MAP_OUT = {  # output shape per rank, from the input (8, 4, 8)
    "copy": lambda W: (8, 4, 8), "reduce": lambda W: (8, 4, 8),
    "scatter": lambda W: (8, 4, 8 // W), "gather": lambda W: (8, 4, 8 * W),
    "sp_scatter": lambda W: (8 // W, 4, 8), "sp_gather": lambda W: (8 * W, 4, 8),
    "sp_gather_split": lambda W: (8 * W, 4, 8),
    "sp_reduce_scatter": lambda W: (8 // W, 4, 8),
}
JMAPS = {
    "copy": jtp.copy_to_tensor_model_parallel_region,
    "reduce": jtp.reduce_from_tensor_model_parallel_region,
    "scatter": jtp.scatter_to_tensor_model_parallel_region,
    "gather": jtp.gather_from_tensor_model_parallel_region,
    "sp_scatter": jtp.scatter_to_sequence_parallel_region,
    "sp_gather": lambda x: jtp.gather_from_sequence_parallel_region(x, "tensor", True),
    "sp_gather_split": lambda x: jtp.gather_from_sequence_parallel_region(
        x, "tensor", False),
    "sp_reduce_scatter": jtp.reduce_scatter_to_sequence_parallel_region,
}


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _tile(a, W):
    return np.stack([a] * W)


def _layer_data(W, dtypes):
    """name -> (dtype, per-rank args, per-rank cotangent)."""
    rng = _rng(10 + W)
    x, w, b = _f32((T, DIN), rng), _f32((DIN, DOUT), rng) * 0.3, _f32((DOUT,), rng)
    cols = np.split(w, W, axis=1)
    rows = np.split(w, W, axis=0)
    bcols = np.split(b, W)
    xrows = np.split(x, W, axis=0)
    xcols = np.split(x, W, axis=1)
    out = {}
    for dt in dtypes:
        def case(name, args, dy_shape):
            out[f"{name}:{dt}"] = (dt, args, _f32((W, *dy_shape), rng))

        col_w, col_b = np.stack(cols), np.stack(bcols)
        case("col", (_tile(x, W), col_w, col_b), (T, DOUT // W))
        case("col_gather", (_tile(x, W), col_w, col_b), (T, DOUT))
        case("col_sp", (np.stack(xrows), col_w, col_b), (T, DOUT // W))
        case("row", (np.stack(xcols), np.stack(rows), _tile(b, W)), (T, DOUT))
        case("row_scatter", (_tile(x, W), np.stack(rows), _tile(b, W)), (T, DOUT))
        case("row_sp", (np.stack(xcols), np.stack(rows), _tile(b, W)), (T // W, DOUT))
        tok = rng.integers(0, VOCAB, (3, 5))
        table = _f32((VOCAB, HID), rng)
        case("embed", (tok, np.stack(np.split(table, W))), (3, 5, HID))
        logits = _f32((N, VOCAB), rng) * 3
        tgt = rng.integers(0, VOCAB, (N,))
        for s in ("0.0", "0.1"):
            for save in ("save", "slim"):
                case(f"ce_{s}_{save}", (np.stack(np.split(logits, W, axis=1)), tgt),
                     (N,))
    return out


def _data():
    data = {}
    for W in SIZES:
        rng = _rng(W)
        X = _f32((W, 8, 4, 8), rng)
        maps = {k: (X, _f32((W, *f(W)), rng)) for k, f in MAP_OUT.items()}
        xs = _f32((8, 4, 16), rng)
        sp_ln = (np.stack(np.split(xs, W)), _f32((16,), rng), _f32((16,), rng),
                 _f32((W, 8 // W, 4, 16), rng))
        data[W] = dict(maps=maps, layers=_layer_data(
            W, ("float32", "bfloat16") if W == 2 else ("float32",)), sp_ln=sp_ln)
    return data


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.run_world(tw.tp_scenario, WORLD, tmp_path_factory.mktemp("tp"),
                        SIZES, _data())


def _per_rank(W, fn, *stacked):
    """``fn`` on each rank's row of ``stacked`` under ``shard_map`` over W
    devices; its outputs stacked by rank."""
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("tensor",))

    def body(*args):
        out = fn(*[a[0] for a in args])
        return jax.tree.map(lambda o: o[None], out)

    return jax.jit(_shard_map(body, mesh=mesh, in_specs=P("tensor"),
                              out_specs=P("tensor")))(*stacked)


def _jvjp(fn, primals, ct):
    out, vjp = jax.vjp(fn, *primals)
    return out, vjp(ct.astype(out.dtype))


def _as(a, dt):
    return jnp.asarray(a, jnp.bfloat16 if dt == "bfloat16" else jnp.float32)


def _jax_layer(W, name, dt, args, dy):
    kind = name.split(":")[0]
    if kind == "embed":
        tok, table = args
        return _per_rank(W, lambda w, c: _jvjp(
            lambda w_: jtp.vocab_parallel_embedding(jnp.asarray(tok), w_,
                                                    vocab_size=VOCAB,
                                                    axis_name="tensor"), [w], c),
            _as(table, dt), _as(dy, dt))
    if kind.startswith("ce"):
        _, s, save = kind.split("_")
        logits, tgt = args
        return _per_rank(W, lambda x, c: _jvjp(
            lambda x_: jtp.vocab_parallel_cross_entropy(
                x_, jnp.asarray(tgt), VOCAB, float(s), "tensor",
                save_softmax=save == "save"), [x], c), _as(logits, dt), _as(dy, dt))
    x, w, b = args
    fns = {
        "col": lambda *a: jtp.column_parallel_linear(*a, axis_name="tensor"),
        "col_gather": lambda *a: jtp.column_parallel_linear(
            *a, gather_output=True, axis_name="tensor"),
        "col_sp": lambda *a: jtp.column_parallel_linear(
            *a, sequence_parallel=True, axis_name="tensor"),
        "row": lambda *a: jtp.row_parallel_linear(*a, axis_name="tensor"),
        "row_scatter": lambda *a: jtp.row_parallel_linear(
            *a, input_is_parallel=False, axis_name="tensor"),
        "row_sp": lambda *a: jtp.row_parallel_linear(
            *a, sequence_parallel=True, axis_name="tensor"),
    }
    return _per_rank(W, lambda x_, w_, b_, c: _jvjp(fns[kind], [x_, w_, b_], c),
                     _as(x, dt), _as(w, dt), _as(b, dt), _as(dy, dt))


def _close(got, ref, dt, msg):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dt == "bfloat16":
        ulp = 2.0 ** -7
        np.testing.assert_allclose(got, ref, rtol=ulp,
                                   atol=2 * ulp * float(np.abs(ref).max()),
                                   err_msg=msg)
    else:
        np.testing.assert_allclose(got, ref, err_msg=msg, **F32)


@pytest.mark.parametrize("W", SIZES)
@pytest.mark.parametrize("name", sorted(MAP_OUT))
def test_mapping_matches_jax(world, W, name):
    X, dY = _data()[W]["maps"][name]
    ref_out, (ref_dx,) = _per_rank(W, lambda x, c: _jvjp(JMAPS[name], [x], c),
                                   jnp.asarray(X), jnp.asarray(dY))
    for rank in range(WORLD):
        r = rank % W
        out, (dx,) = world[rank][0][W][name]
        _close(out, ref_out[r], "float32", f"{name} W={W} rank {rank} out")
        _close(dx, ref_dx[r], "float32", f"{name} W={W} rank {rank} dx")


def _layer_names():
    return [(W, n) for W in SIZES for n in sorted(_layer_data(W, (
        ("float32", "bfloat16") if W == 2 else ("float32",))))]


@pytest.mark.parametrize("W, name", _layer_names(),
                         ids=[f"W{W}-{n}" for W, n in _layer_names()])
def test_layer_matches_jax(world, W, name):
    dt, args, dy = _data()[W]["layers"][name]
    ref_out, ref_grads = _jax_layer(W, name, dt, args, dy)
    for rank in range(WORLD):
        r = rank % W
        out, grads = world[rank][0][W][name]
        _close(out, ref_out[r], dt, f"{name} W={W} rank {rank} out")
        assert len(grads) == len(ref_grads)
        for i, (g, rg) in enumerate(zip(grads, ref_grads)):
            _close(g, rg[r], dt, f"{name} W={W} rank {rank} grad {i}")


@pytest.mark.parametrize("W", SIZES)
def test_chunked_collectives_are_bitwise(world, W):
    """``set_collective_chunk_bytes``: every mapping with its gathers and
    reduce-scatters issued as 64-byte chunks gives the single collective's
    bits; the setter returns the previous budget."""
    for rank in range(WORLD):
        res = world[rank][0][W]
        assert all(res["chunked_bitwise"].values()), res["chunked_bitwise"]
        assert res["chunk_budget"] == (64, None)


@pytest.mark.parametrize("W", SIZES)
def test_sp_layer_norm_param_grads_are_tensor_reduced(world, W):
    """Each rank normalizes its sequence shard; the scale and bias
    gradients equal the whole sequence's, on every rank, and JAX's."""
    x, s, b, dy = _data()[W]["sp_ln"]
    ref_out, ref_grads = _per_rank(W, lambda x_, c: _jvjp(
        lambda xx, ss, bb: jsp_ln(xx, ss, bb, sequence_parallel=True,
                                  axis_name="tensor"),
        [x_, jnp.asarray(s), jnp.asarray(b)], c), jnp.asarray(x), jnp.asarray(dy))
    # the whole sequence's parameter gradients, from the dense norm
    xf = x.reshape(-1, 16)
    mu = xf.mean(-1, keepdims=True)
    xhat = (xf - mu) / np.sqrt(xf.var(-1, keepdims=True) + 1e-5)
    dyf = dy.reshape(-1, 16)
    whole = ((dyf * xhat).sum(0), dyf.sum(0))
    for rank in range(WORLD):
        r = rank % W
        out, grads = world[rank][0][W]["sp_ln"]
        _close(out, ref_out[r], "float32", f"sp_ln W={W} out")
        for i in range(3):
            _close(grads[i], ref_grads[i][r], "float32", f"sp_ln W={W} grad {i}")
        for g, want in zip(grads[1:], whole):
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("W", SIZES)
def test_found_inf_reaches_the_tensor_group(world, W):
    """Global rank 1's overflow: every rank of its tensor group sees it,
    through reduce_found_inf and GradScaler.unscale, and no other rank."""
    for rank in range(WORLD):
        mine = rank // W == 1 // W
        assert world[rank][0][W]["found_inf"] is mine
        assert world[rank][0][W]["scaler_found_inf"] is mine


@pytest.mark.parametrize("W", SIZES)
def test_broadcast_data(world, W):
    for rank in range(WORLD):
        res = world[rank][0][W]
        # every rank holds tensor rank 0's batch (filled with its rank, 0)
        np.testing.assert_array_equal(res["broadcast"]["text"], np.zeros((2, 3)))
        np.testing.assert_array_equal(res["broadcast"]["mask"], np.zeros(2))
        assert res["broadcast_same"] is True
    assert world[0][1] == ["KeyError", "TypeError"]


def test_memory_buffers(world):
    state = world[0][2]
    want = np.zeros(12, np.float32)
    want[4:10] = 7.0
    np.testing.assert_array_equal(state["data"], want)
    assert state["cycle"] and state["zeroed"]
    assert "exceeds buffer size 12" in state["over"]
