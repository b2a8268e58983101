"""Port parity: the flagship GPT over tensor and pipeline parallelism
(``testing/gpt.py``'s tensor-parallel forward, ``shard_params`` /
``unshard_params``, and the amp O5 step over TP x PP that
``tests/_torch_world.py`` ``gpt_tp_pp_o5`` builds from the public functions,
as a Megatron user script would), at a small size (vocab 128, seq 32,
d_model 64, 4 heads, 2 layers, batch 4), in one gloo world of 4 processes.

* ``shard_params`` / ``unshard_params`` round trip bitwise over (tp, pp) in
  {1, 2, 4} x {1, 2}; a tensor shard's ``wqkv``/``bqkv`` hold its heads' q,
  k and v columns;
* at a tensor world of 1 the TP forward is the dense forward, bit for bit
  (fp32 and bf16, sequence parallel off and on);
* TP 2, sequence parallel off and on, fp32: the loss and the reassembled
  gradients against JAX's dense ``gpt.loss_fn`` and JAX's GSPMD run
  (``tests/test_gpt_flagship.py:56-89``), at JAX's bounds: loss rtol 2e-5,
  grads atol 1e-4, rtol 2e-3;
* three amp O5 steps at TP 2 x PP 2 (1F1B, two microbatches of 2;
  sequence parallel off and on) against the JAX package's eager O5 step on
  the whole model at batch 4, at PERF.md's GPT O5 bf16 row: loss rtol
  1e-3, grads 2^-7 relative + 2e-3 (step 1) / 1e-2 absolute, masters 3·lr
  a step; no overflow; the replicated leaves bitwise equal across each
  tensor group, the non-block leaves across the pipe group;
* dropout under TP (rates 0.1): two amp O5 steps with a dropout key at TP
  2, sequence parallel off and on, every layer drawing from the one key (as
  JAX's layer scan traces its body once). Every keep mask a rank draws is
  its part of the one-device model's mask of the same site, bit for bit
  (its heads' planes of the attention probabilities, its rows of the
  residual under sequence parallelism), and it draws the one-device step's
  sites and no others. The steps match the port's one-device dropout step
  at the same key, and JAX's eager O5 step fed the port's one-device masks
  through ``jax.random.bernoulli``, at the GPT O5 bf16 row above.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu import amp as jamp  # noqa: E402
from beforeholiday_tpu.optimizers import FusedAdam as JFusedAdam  # noqa: E402
from beforeholiday_tpu.parallel import parallel_state as jps  # noqa: E402
from beforeholiday_tpu.testing import gpt as jgpt  # noqa: E402
from beforeholiday_tpu_torch.ops import attention as tattn  # noqa: E402
from beforeholiday_tpu_torch.testing import gpt as tgpt  # noqa: E402
from beforeholiday_tpu_torch.transformer.tensor_parallel import random as trandom  # noqa: E402

_set_mesh = getattr(jax.sharding, "set_mesh", None) or (lambda m: m)

SMALL = dict(vocab_size=128, seq_len=32, d_model=64, n_heads=4, n_layers=2)
BATCH, LR, STEPS = 4, 1e-3, 3
O5_RUNS = [("tp2_pp2", 2, 2, False, 2, STEPS, LR),
           ("tp2_pp2_sp", 2, 2, True, 2, STEPS, LR)]
RATES = dict(dropout_rate=0.1, attention_dropout=0.1)
DROP_SEED, DROP_STEPS = 11, 2
# (label, tp (0: dense), sp, seed, one key for every layer, steps, lr, rates)
# every layer draws from the one key, as JAX's layer scan does, so the same
# runs are held against the port's one-device step and against JAX's
DROPOUT_RUNS = [(f"drop_{name}", tp, sp, DROP_SEED, True, DROP_STEPS, LR, RATES)
                for name, tp, sp in (("dense", 0, False), ("tp2", 2, False),
                                     ("tp2_sp", 2, True))]
BF16_ULP = 2.0 ** -7
# (rank of a TP x PP layout) -> (pipe rank, tensor rank): (pipe, data, tensor)
LAYOUT = {r: (r // 2, r % 2) for r in range(4)}


def _params():
    return jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0),
                                              jgpt.GPTConfig(**SMALL)))


def _batch():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, SMALL["vocab_size"], (BATCH, SMALL["seq_len"]))
    return tok.astype(np.int32), np.roll(tok, -1, axis=-1).astype(np.int32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.run_world(tw.gpt_tp_scenario, 4, tmp_path_factory.mktemp("gpt_tp"),
                        SMALL, _params(), *_batch(), O5_RUNS, DROPOUT_RUNS)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees(got, ref, msg, **tol):
    ref_leaves = dict((jax.tree_util.keystr(p), v) for p, v in _flat(ref))
    got_leaves = dict((jax.tree_util.keystr(p), v) for p, v in _flat(got))
    assert set(got_leaves) == set(ref_leaves)
    for k, v in ref_leaves.items():
        np.testing.assert_allclose(np.asarray(got_leaves[k]),
                                   np.asarray(v, np.float32), err_msg=f"{msg} {k}",
                                   **tol)


@pytest.mark.parametrize("tp, pp", [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (4, 2)])
def test_shard_round_trip_is_bitwise(tp, pp):
    cfg = tgpt.GPTConfig(**SMALL)
    params = tgpt.params_from_numpy(_params(), device="cpu")
    shards = [[tgpt.shard_params(params, cfg, t, tp, p, pp) for t in range(tp)]
              for p in range(pp)]
    back = tgpt.unshard_params(shards, cfg)
    for (path, a), (_, b) in zip(_flat(jax.tree.map(np.asarray, back)),
                                 _flat(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    s = shards[-1][-1]
    assert s["blocks"]["wqkv"].shape == (2 // pp, 64, 3 * 64 // tp)
    assert s["tok_embed"].shape == (128 // tp, 64)


def test_wqkv_shard_holds_its_heads_q_k_v():
    cfg = tgpt.GPTConfig(**SMALL)
    params = tgpt.params_from_numpy(_params(), device="cpu")
    D, dl = 64, 32  # two of four heads a rank
    for r in range(2):
        s = tgpt.shard_params(params, cfg, r, 2)
        for name in ("wqkv", "bqkv"):
            full, mine = params["blocks"][name], s["blocks"][name]
            for j in range(3):  # q, k, v
                assert torch.equal(mine[..., j * dl:(j + 1) * dl],
                                   full[..., j * D + r * dl:j * D + (r + 1) * dl])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sp", [False, True])
def test_world1_forward_is_the_dense_forward(world, dt, sp):
    for rank in range(4):
        assert world[rank][("world1", dt, sp)] is True


def _jax_dense():
    cfg = jgpt.GPTConfig(**SMALL)
    tok, tgt = (jnp.asarray(a) for a in _batch())
    return jax.value_and_grad(jgpt.loss_fn)(jax.tree.map(jnp.asarray, _params()),
                                            tok, tgt, cfg)


def _jax_gspmd(sp):
    cfg = jgpt.GPTConfig(**SMALL, sequence_parallel=sp)
    tok, tgt = _batch()
    state = jps.initialize_model_parallel(tensor_model_parallel_size=2,
                                          pipeline_model_parallel_size=1,
                                          devices=jax.devices())
    try:
        mesh = state.mesh
        sharded = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                               _params(), jgpt.param_specs(cfg))
        bsh = NamedSharding(mesh, P(jps.DATA_AXIS, None))
        with _set_mesh(mesh):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, t, y: jgpt.loss_fn(p, t, y, cfg)))(
                sharded, jax.device_put(tok, bsh), jax.device_put(tgt, bsh))
        return float(loss), jax.tree.map(np.asarray, grads)
    finally:
        jps.destroy_model_parallel()


@pytest.mark.parametrize("sp", [False, True])
def test_tp2_matches_jax_dense_and_gspmd(world, sp):
    cfg = tgpt.GPTConfig(**SMALL, sequence_parallel=sp)
    (l0, g0), (l1, g1) = world[0][("tp2", sp)], world[1][("tp2", sp)]
    assert l0 == l1
    grads = jax.tree.map(np.asarray, tgpt.unshard_params(
        [[_torchify(g0), _torchify(g1)]], cfg))
    ref_loss, ref_grads = _jax_dense()
    gspmd_loss, gspmd_grads = _jax_gspmd(sp)
    for loss_ref, grads_ref, name in ((float(ref_loss), ref_grads, "dense"),
                                      (gspmd_loss, gspmd_grads, "gspmd")):
        np.testing.assert_allclose(l0, loss_ref, rtol=2e-5, err_msg=name)
        _assert_trees(grads, grads_ref, name, atol=1e-4, rtol=2e-3)


def _torchify(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _jax_o5(steps):
    """The JAX package's eager O5 arena-native FusedAdam step on the whole
    model at batch 4, ``steps`` times on the same batch."""
    cfg = jgpt.GPTConfig(**SMALL, dtype=jnp.bfloat16)
    params = jax.tree.map(jnp.asarray, _params())
    m = jamp.initialize(lambda p, t: jgpt.forward(p, t, cfg), params,
                        JFusedAdam(lr=LR), "O5", arena_native=True)
    svag = jamp.scaled_value_and_grad(
        lambda p, tok, tgt: jgpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply),
        m.scaler)
    p, o, s = m.params, m.optimizer.init(m.params), m.scaler.init()
    tok, tgt = (jnp.asarray(a) for a in _batch())
    out = []
    for _ in range(steps):
        loss, g, fi, s = svag(p, s, tok, tgt)
        p, o = m.optimizer.step(p, g, o, found_inf=fi)
        out.append(dict(loss=float(loss), found_inf=bool(fi),
                        grads=jax.tree.map(np.asarray, g.unpack()),
                        masters=jax.tree.map(np.asarray,
                                             p.replace_arenas(o["master"]).unpack())))
    return out


@pytest.fixture(scope="module")
def jax_o5():
    return _jax_o5(STEPS)


def _assemble(world, label, step, key):
    cfg = tgpt.GPTConfig(**SMALL)
    shards = [[None, None], [None, None]]
    for rank, (pr, tr) in LAYOUT.items():
        shards[pr][tr] = _torchify(world[rank][label][step][key])
    return jax.tree.map(np.asarray, tgpt.unshard_params(shards, cfg))


@pytest.mark.parametrize("label", [r[0] for r in O5_RUNS])
@pytest.mark.parametrize("step", range(STEPS))
def test_o5_tp2_pp2_step_matches_jax(world, jax_o5, label, step):
    j = jax_o5[step]
    runs = [world[rank][label][step] for rank in range(4)]
    for r in runs:
        assert r["found_inf"] is False and j["found_inf"] is False
        assert r["loss"] == runs[0]["loss"]
        assert r["replicated"] is True
    np.testing.assert_allclose(runs[0]["loss"], j["loss"], rtol=1e-3)
    atol = 2e-3 if step == 0 else 1e-2
    _assert_trees(_assemble(world, label, step, "grads"), j["grads"], "grads",
                  atol=atol, rtol=BF16_ULP)
    _assert_trees(_assemble(world, label, step, "masters"), j["masters"], "masters",
                  atol=3 * LR * (step + 1), rtol=0)
    # the leaves outside the blocks are whole on both pipe ranks, bitwise
    for t in range(2):
        a, b = runs[LAYOUT_INV[(0, t)]], runs[LAYOUT_INV[(1, t)]]
        for k in ("tok_embed", "pos_embed", "lnf_scale", "lnf_bias"):
            np.testing.assert_array_equal(a["masters"][k], b["masters"][k])


LAYOUT_INV = {v: k for k, v in LAYOUT.items()}


# ------------------------------------------------------- dropout under TP


def _one_device_mask(key, shape, rate, place):
    """The one-device mask's part that ``place`` names, drawn whole and
    sliced here (the ranks draw only their part)."""
    key = torch.from_numpy(key)
    if place is None:
        return tattn.dropout_keep_mask_torch(key, shape, rate).numpy()
    hl, H, h0, r0 = place
    BH, R, C = shape
    whole = tattn.dropout_keep_mask_torch(key, (BH // hl * H, r0 + R, C), rate)
    planes = tattn.RankPlace(*place).plane(torch.arange(BH))
    return whole[planes, r0:].numpy()


def _drop_runs(world, label):
    """The TP 2 run's two tensor ranks (world ranks 0 and 1: data rank 0)."""
    return world[0][label], world[1][label]


@pytest.mark.parametrize("label", [r[0] for r in DROPOUT_RUNS if r[1]])
def test_tp_dropout_draws_the_one_device_masks(world, label):
    ref = world[0]["drop_dense"][0]["masks"]
    ref_keys = sorted(tuple(k) for k, *_ in ref)
    for tr, run in enumerate(_drop_runs(world, label)):
        masks = run[0]["masks"]
        assert sorted(tuple(k) for k, *_ in masks) == ref_keys
        places = set()
        for key, shape, rate, place, mask in masks:
            np.testing.assert_array_equal(mask, _one_device_mask(key, shape, rate, place),
                                          err_msg=f"{label} rank {tr} {shape} {place}")
            places.add(place)
        heads = SMALL["n_heads"] // 2
        assert (heads, SMALL["n_heads"], tr * heads, 0) in places
        if "_sp" in label:
            assert (1, 1, 0, tr * SMALL["seq_len"] // 2) in places


def _assert_drop_step(got, ref, step, name):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-3, err_msg=name)
    atol = 2e-3 if step == 0 else 1e-2
    _assert_trees(got["grads"], ref["grads"], f"{name} grads", atol=atol, rtol=BF16_ULP)
    _assert_trees(got["masters"], ref["masters"], f"{name} masters",
                  atol=3 * LR * (step + 1), rtol=0)


def _drop_assembled(world, label, step):
    cfg = tgpt.GPTConfig(**SMALL)
    runs = _drop_runs(world, label)
    assert all(r[step]["found_inf"] is False for r in runs)
    assert runs[0][step]["loss"] == runs[1][step]["loss"]
    return dict(loss=runs[0][step]["loss"], **{
        k: jax.tree.map(np.asarray, tgpt.unshard_params(
            [[_torchify(r[step][k]) for r in runs]], cfg)) for k in ("grads", "masters")})


@pytest.mark.parametrize("label", ["drop_tp2", "drop_tp2_sp"])
@pytest.mark.parametrize("step", range(DROP_STEPS))
def test_tp_dropout_step_matches_the_one_device_step(world, label, step):
    _assert_drop_step(_drop_assembled(world, label, step), world[0]["drop_dense"][step],
                      step, label)


def _jax_o5_dropout(steps):
    """JAX's eager O5 step with a dropout key, ``jax.random.bernoulli`` fed
    the port's one-device masks of the one key every layer draws from."""
    B, S, D, H = BATCH, SMALL["seq_len"], SMALL["d_model"], SMALL["n_heads"]
    key = trandom.make_key(DROP_SEED, device="cpu")

    def mask(site, shape):
        return tattn.dropout_keep_mask_torch(trandom.fold_in(key, site), shape, 0.1)

    hid = (B, S, D)
    by_shape = {hid: [mask(0x7FFFFFFF, hid)] + [mask(1, hid), mask(2, hid)] * 2,
                (B * H, S, S): [mask(0, (B * H, S, S))]}
    cfg = jgpt.GPTConfig(**SMALL, **RATES, dtype=jnp.bfloat16)
    params = jax.tree.map(jnp.asarray, _params())
    m = jamp.initialize(lambda p, t: jgpt.forward(p, t, cfg,
                                                  dropout_key=jax.random.PRNGKey(5)),
                        params, JFusedAdam(lr=LR), "O5", arena_native=True)
    svag = jamp.scaled_value_and_grad(
        lambda p, tok, tgt: jgpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply),
        m.scaler)
    p, o, s = m.params, m.optimizer.init(m.params), m.scaler.init()
    tok, tgt = (jnp.asarray(a) for a in _batch())
    out = []
    bernoulli = jax.random.bernoulli
    try:
        for _ in range(steps):
            jax.random.bernoulli = _Bernoulli(by_shape)
            loss, g, fi, s = svag(p, s, tok, tgt)
            p, o = m.optimizer.step(p, g, o, found_inf=fi)
            out.append(dict(loss=float(loss), found_inf=bool(fi),
                            grads=jax.tree.map(np.asarray, g.unpack()),
                            masters=jax.tree.map(np.asarray,
                                                 p.replace_arenas(o["master"]).unpack())))
    finally:
        jax.random.bernoulli = bernoulli
    return out


class _Bernoulli:
    """``jax.random.bernoulli`` returning the given masks by shape, in call
    order (the last one repeats)."""

    def __init__(self, by_shape):
        self.queues = {s: list(m) for s, m in by_shape.items()}

    def __call__(self, key, p, shape):
        queue = self.queues[tuple(shape)]
        mask = queue.pop(0) if len(queue) > 1 else queue[0]
        return jnp.asarray(mask.numpy().reshape(shape))


@pytest.fixture(scope="module")
def jax_o5_dropout():
    return _jax_o5_dropout(DROP_STEPS)


@pytest.mark.parametrize("label", ["drop_tp2", "drop_tp2_sp"])
@pytest.mark.parametrize("step", range(DROP_STEPS))
def test_tp_dropout_step_matches_jax_fed_the_masks(world, jax_o5_dropout, label, step):
    assert jax_o5_dropout[step]["found_inf"] is False
    _assert_drop_step(_drop_assembled(world, label, step), jax_o5_dropout[step], step,
                      label)
