"""Port parity: BERT (``testing/bert.py``) and its amp O5, arena-native
FusedLAMB pretraining step (``bench.py`` ``make_bert_rung``), held against
the JAX package on the same numpy parameters and batch at a small size
(vocab 512, seq 128, d 64, 4 heads, 2 layers, batch 2, ``seq_lens`` [128,
77]).

The JAX side runs each step (and the forward) under ``jax.jit``, with its
Pallas unscale and LAMB kernels in interpret mode (``impl="pallas"``) and
its attention through the jnp reference (``attention_impl="jnp"``: the
Pallas flash kernels are held against the port in
``test_torch_attention.py``). Eager JAX would re-trace and recompile its
layer scan on every call, several seconds a step; under jit XLA's CPU
compiler drops some bf16 intermediate roundings that eager JAX keeps, and
the bf16-activation tolerances cover that. The port runs the kernels' plain
versions (CPU tensors). Tolerances, what was measured, and why, are in
PERF.md.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import amp as jamp
from beforeholiday_tpu.ops import arena as jarena
from beforeholiday_tpu.optimizers import FusedLAMB as JFusedLAMB
from beforeholiday_tpu.testing import bert as jbert
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_paths
from beforeholiday_tpu_torch.optimizers import FusedLAMB as TFusedLAMB
from beforeholiday_tpu_torch.testing import bert as tbert
from beforeholiday_tpu_torch.transformer.tensor_parallel.random import make_key

SMALL = dict(vocab_size=512, seq_len=128, d_model=64, n_heads=4, n_layers=2)
LENS = [128, 77]
LR = 1e-3
STEPS = 3
BF16_ULP = 2.0 ** -7


def _batch(seed=1, batch=2):
    """Seeded numpy MLM batch: tokens, targets, mask, NSP labels, lens."""
    rng = np.random.default_rng(seed)
    cfg = SMALL
    targets = rng.integers(0, cfg["vocab_size"] - 1, (batch, cfg["seq_len"]))
    mask = (rng.random((batch, cfg["seq_len"])) < 0.15).astype(np.float32)
    tokens = np.where(mask > 0, cfg["vocab_size"] - 1, targets)
    nsp = rng.integers(0, 2, (batch,))
    return (tokens.astype(np.int32), targets.astype(np.int32), mask,
            nsp.astype(np.int32), np.asarray(LENS, np.int32))


def _jax_batch(seed=1):
    return tuple(jnp.asarray(a) for a in _batch(seed))


def _port_batch(seed=1):
    tok, tgt, mask, nsp, lens = _batch(seed)
    return (torch.from_numpy(tok).long(), torch.from_numpy(tgt).long(),
            torch.from_numpy(mask), torch.from_numpy(nsp).long(),
            torch.from_numpy(lens))


def _jax_params(cfg):
    return jbert.init(jax.random.PRNGKey(0), cfg)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _f32(a):
    return np.asarray(a, dtype=np.float32)


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("token_types", [False, True])
def test_forward_and_loss_match_jax_fp32(token_types):
    """MLM and NSP logits and the pretraining loss, fp32 throughout."""
    jcfg = jbert.BertConfig(**SMALL, attention_impl="jnp")
    params = _jax_params(jcfg)
    tok, tgt, mask, nsp, lens = _batch()
    types = (np.random.default_rng(2).integers(0, 2, tok.shape).astype(np.int32)
             if token_types else None)
    jmlm, jnsp = jax.jit(functools.partial(jbert.forward, cfg=jcfg))(
        params, jnp.asarray(tok),
        token_types=None if types is None else jnp.asarray(types),
        seq_lens=jnp.asarray(lens))
    jloss = jax.jit(functools.partial(jbert.pretrain_loss, cfg=jcfg))(
        params, *_jax_batch()[:4], seq_lens=jnp.asarray(lens))
    cfg = tbert.BertConfig(**SMALL)
    tp = tbert.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    mlm, nspl = tbert.forward(tp, torch.from_numpy(tok).long(), cfg,
                              token_types=None if types is None
                              else torch.from_numpy(types).long(),
                              seq_lens=torch.from_numpy(lens))
    assert mlm.dtype == nspl.dtype == torch.float32
    assert mlm.shape == (2, SMALL["seq_len"], SMALL["vocab_size"])
    np.testing.assert_allclose(mlm.numpy(), np.asarray(jmlm), atol=1e-4, rtol=0)
    np.testing.assert_allclose(nspl.numpy(), np.asarray(jnsp), atol=1e-5, rtol=0)
    loss = tbert.pretrain_loss(tp, *_port_batch()[:4], cfg,
                               seq_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


def test_init_matches_the_reference_distributions():
    """Same tree, shapes and standard deviations as the JAX ``init``
    (``wo``/``wo2`` scaled by 1/sqrt(2L)); different numbers."""
    cfg = tbert.BertConfig(**{**SMALL, "n_layers": 4})
    jp = jax.tree.map(np.asarray, _jax_params(jbert.BertConfig(**{**SMALL, "n_layers": 4})))
    tp = tbert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jl, tl = jax.tree_util.tree_leaves_with_path(jp), tree_flatten(tp)[0]
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        assert t.shape == j.shape and t.dtype == torch.float32, path
        np.testing.assert_allclose(t.std().item(), j.std(), rtol=0.15, atol=1e-6)
        np.testing.assert_allclose(t.mean().item(), j.mean(), atol=0.01)


def test_unported_paths_raise():
    """The unfused softmax path builds and runs; dropout rates are accepted
    (they act only with a dropout key, as in JAX); a forward with a dropout
    key runs and drops."""
    unfused = tbert.BertConfig(**SMALL, use_flash_attention=False)
    up = tbert.init(unfused, torch.Generator().manual_seed(0), device="cpu")
    mlm, nsp = tbert.forward(up, _port_batch()[0], unfused,
                             seq_lens=_port_batch()[4])
    assert mlm.shape == (2, SMALL["seq_len"], SMALL["vocab_size"])
    assert torch.isfinite(mlm).all() and torch.isfinite(nsp).all()
    cfg = tbert.BertConfig(**SMALL, dropout_rate=0.1, attention_dropout=0.1)
    tp = tbert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mlm, _ = tbert.forward(tp, _port_batch()[0], cfg)
    assert torch.isfinite(mlm).all()
    key = make_key(0, device="cpu")
    dropped, _ = tbert.forward(tp, _port_batch()[0], cfg, dropout_key=key)
    assert torch.isfinite(dropped).all() and not torch.equal(dropped, mlm)


def test_synthetic_batch_masks_with_the_mask_token():
    cfg = tbert.BertConfig(**SMALL)
    tok, tgt, mask, nsp = tbert.synthetic_batch(
        cfg, 4, generator=torch.Generator().manual_seed(3), device="cpu")
    assert tok.shape == tgt.shape == mask.shape == (4, SMALL["seq_len"])
    assert torch.equal(tok[mask > 0], torch.full_like(tok[mask > 0],
                                                      tbert.mask_token_id(cfg)))
    assert torch.equal(tok[mask == 0], tgt[mask == 0])
    assert int(tgt.max()) < tbert.mask_token_id(cfg) and nsp.shape == (4,)
    assert 0.05 < float(mask.mean()) < 0.3


# ------------------------------------------------------- the O5 LAMB step


def _jax_run(act_dtype, steps, loss_scale=None, loss_weight=None):
    cfg = jbert.BertConfig(**SMALL, dtype=act_dtype, attention_impl="jnp")
    params = _jax_params(cfg)
    m = jamp.initialize(lambda p, t: jbert.forward(p, t, cfg), params,
                        JFusedLAMB(lr=LR, weight_decay=0.01, impl="pallas"),
                        "O5", arena_native=True, loss_scale=loss_scale)
    tok, tgt, mask, nsp, lens = _jax_batch()

    def loss_fn(pk):
        loss = jbert.pretrain_loss(pk.unpack(), tok, tgt, mask, nsp, cfg,
                                   seq_lens=lens)
        return loss if loss_weight is None else loss * loss_weight

    svag = jamp.scaled_value_and_grad(loss_fn, m.scaler, impl="pallas")

    def step(p, o, s):
        loss, g, fi, s = svag(p, s)
        p, o = m.optimizer.step(p, g, o, found_inf=fi)
        return p, o, s, loss, g, fi

    step = jax.jit(step)
    p, o, s = m.params, m.optimizer.init(m.params), m.scaler.init()
    start = jax.tree.map(np.asarray, (p.arenas, o))
    out = []
    for _ in range(steps):
        p, o, s, loss, g, fi = step(p, o, s)
        out.append(jax.tree.map(np.asarray, dict(
            loss=loss, grads=g.arenas, found_inf=fi, model=p.arenas, opt=o,
            scaler=s)))
    return jax.tree.map(np.asarray, params), m.params.layout, start, out


def _port_run(np_params, act_dtype, steps, loss_scale=None, loss_weight=None):
    cfg = tbert.BertConfig(**SMALL, dtype=act_dtype)
    params = tbert.params_from_numpy(np_params, device="cpu")
    m = tamp.initialize(lambda p, t: tbert.forward(p, t, cfg), params,
                        TFusedLAMB(lr=LR, weight_decay=0.01), "O5",
                        arena_native=True, loss_scale=loss_scale)
    tok, tgt, mask, nsp, lens = _port_batch()

    def loss_fn(pk):
        loss = tbert.pretrain_loss(pk.unpack(), tok, tgt, mask, nsp, cfg,
                                   seq_lens=lens)
        return loss if loss_weight is None else loss * loss_weight

    svag = tamp.scaled_value_and_grad(loss_fn, m.scaler)
    o, s = m.optimizer.init(m.params), m.scaler.init(device="cpu")
    start = (_clone(list(m.params.arenas)), _clone(o))
    out = []
    for _ in range(steps):
        loss, g, fi, s = svag(m.params, s)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        out.append(dict(loss=loss, grads=g.arenas, found_inf=fi,
                        model=[a.clone() for a in m.params.arenas],
                        opt=_clone(o), scaler=dict(s)))
    return m, start, out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


@pytest.fixture(scope="module", params=["fp32_act", "bf16_act"])
def runs(request):
    jdt, tdt = ((jnp.float32, torch.float32) if request.param == "fp32_act"
                else (jnp.bfloat16, torch.bfloat16))
    np_params, jlayout, jstart, jout = _jax_run(jdt, STEPS)
    m, tstart, tout = _port_run(np_params, tdt, STEPS)
    return request.param, jlayout, jstart, jout, m, tout


# per activation dtype; measured worst cases are in PERF.md's tolerance table
TOL = {
    # fp32 compute over bf16 weights: step 1's grads are the same fp32
    # values rounded once to bf16; LAMB moves each weight by at most about
    # lr times its tensor's trust ratio, so later steps may differ by that
    "fp32_act": dict(loss=1e-5, grad_atol=(1e-6, 1e-4), grad_rtol=BF16_ULP,
                     master=1e-4, sq_atol=1e-6),
    # bf16 activations: every layer rounds to bf16 at other places in the
    # two frameworks; the dense layers round once, as in JAX (the atol is
    # about twice the worst measured, 1.8e-3 at step 1, 2.1e-3 by step 3)
    "bf16_act": dict(loss=1e-3, grad_atol=(5e-3, 5e-3), grad_rtol=BF16_ULP,
                     master=3 * LR, sq_atol=1e-5),
}


def test_packed_layout_matches_jax(runs):
    """Same dtype buckets, leaf indices, offsets and padding; only the
    blocks' ``ln1``/``ln2`` leaves stay fp32 (``embed_ln``/``mlm_ln`` are
    cast to bf16, by name, as in JAX); the arenas at init are equal."""
    _, jlayout, jstart, _, m, _ = runs
    lay = m.params.layout
    assert [str(d).replace("torch.", "") for d in lay.dtypes] == [
        jnp.dtype(d).name for d in jlayout.dtypes] == ["bfloat16", "float32"]
    assert lay.indices == jlayout.indices
    for ts, js in zip(lay.specs, jlayout.specs):
        assert (ts.shapes, ts.offsets, ts.total, ts.padded_total) == (
            js.shapes, js.offsets, js.total, js.padded_total)
    tree = m.params.unpack()
    kept = {k for k, v in tree["blocks"].items() if v.dtype == torch.float32}
    assert kept == {"ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"}
    assert tree["embed_ln_scale"].dtype == tree["mlm_ln_bias"].dtype == torch.bfloat16
    for got, ref in zip(runs[-1][0]["model"], jstart[0]):
        assert got.shape == ref.shape


@pytest.mark.parametrize("step", range(STEPS))
def test_lamb_step_matches_jax(runs, step):
    """Loss, found_inf, grad arenas, masters, moments, model arenas, step
    count and scaler state after each of three steps."""
    name, _, _, jout, _, tout = runs
    tol = TOL[name]
    g_atol, g_rtol = tol["grad_atol"][min(step, 1)], tol["grad_rtol"]
    j, t = jout[step], tout[step]
    np.testing.assert_allclose(t["loss"].item(), float(j["loss"]), rtol=tol["loss"])
    assert bool(t["found_inf"]) == bool(j["found_inf"]) is False
    packed = runs[4].params
    for b, (got, ref) in enumerate(zip(t["grads"], j["grads"])):
        assert got.dtype == torch.float32
        _assert_arena_close(packed, b, got, ref, rtol=g_rtol, atol=g_atol)
    for b in range(2):
        jo, to = j["opt"]["inner"][b], t["opt"]["inner"][b]
        assert int(to["step"]) == int(jo["step"]) == step + 1
        np.testing.assert_allclose(_np(t["opt"]["master"][b]),
                                   _f32(j["opt"]["master"][b]),
                                   atol=tol["master"] * (step + 1), rtol=0)
        _assert_arena_close(packed, b, to["exp_avg"], jo["exp_avg"],
                            rtol=g_rtol, atol=g_atol)
        _assert_arena_close(packed, b, to["exp_avg_sq"], jo["exp_avg_sq"],
                            rtol=2 * g_rtol, atol=tol["sq_atol"])
        # the model arena is the master cast to its dtype, bit for bit
        np.testing.assert_array_equal(
            _np(t["model"][b]),
            _np(t["opt"]["master"][b].to(t["model"][b].dtype)))
        # the padding stays 0
        spec = runs[4].params.layout.specs[b]
        assert torch.all(t["opt"]["master"][b][spec.total:] == 0)
    for key in ("scale", "unskipped", "consecutive_overflows"):
        assert t["scaler"][key].item() == j["scaler"][key].item()


# the (D,) row type_embed[0] is added to every position, so its gradient is
# a bf16 sum over B*S cotangents: XLA's CPU reduce rounds its partial sums
# to bf16, PyTorch accumulates in fp32 and rounds once (measured up to 1.5%
# of the leaf's largest gradient apart at B*S = 256)
TYPE_EMBED_TOL = 3e-2


def _assert_arena_close(packed, b, got, ref, *, rtol, atol):
    """Arena ``b`` of the port against JAX's, leaf by leaf: the type
    embedding's gradient (and the moments made from it) within
    TYPE_EMBED_TOL of its largest value, every other leaf within
    ``rtol``/``atol``."""
    got, ref = _np(got), _f32(ref)
    lay = packed.layout
    paths = tree_paths(packed.unpack())
    spec = lay.specs[b]
    for i, off, shape in zip(lay.indices[b], spec.offsets, spec.shapes):
        sl = slice(off, off + int(np.prod(shape)))
        tol = (dict(rtol=TYPE_EMBED_TOL,
                    atol=TYPE_EMBED_TOL * float(np.abs(ref[sl]).max()))
               if paths[i] == ("type_embed",) else dict(rtol=rtol, atol=atol))
        np.testing.assert_allclose(got[sl], ref[sl], err_msg=str(paths[i]), **tol)


def test_loss_falls_on_a_fixed_batch(runs):
    tout = runs[-1]
    losses = [t["loss"].item() for t in tout]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ---------------------------------------------------------------- skip step


@pytest.fixture(scope="module")
def skipped():
    """One step whose loss is weighted by inf (every gradient inf or NaN),
    with a dynamic loss scale, in both packages."""
    np_params, _, jstart, jout = _jax_run(jnp.float32, 1, loss_scale="dynamic",
                                          loss_weight=jnp.inf)
    m, tstart, tout = _port_run(np_params, torch.float32, 1,
                                loss_scale="dynamic", loss_weight=float("inf"))
    return jstart, jout[0], tstart, tout[0]


def test_skip_step_leaves_state_untouched(skipped):
    """Both packages skip: masters, moments, model arenas and the step
    count bitwise unchanged, the dynamic scale halved."""
    jstart, j, (p0, o0), t = skipped
    assert bool(t["found_inf"]) and bool(j["found_inf"])
    for a, b in zip(t["model"], p0):
        assert torch.equal(a, b)
    for b in range(2):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(t["opt"]["inner"][b][key], o0["inner"][b][key])
            np.testing.assert_array_equal(j["opt"]["inner"][b][key],
                                          jstart[1]["inner"][b][key])
        assert torch.equal(t["opt"]["master"][b], o0["master"][b])
        np.testing.assert_array_equal(j["opt"]["master"][b],
                                      jstart[1]["master"][b])
        np.testing.assert_array_equal(_f32(j["model"][b]), _f32(jstart[0][b]))
    assert int(t["opt"]["inner"][0]["step"]) == 0
    assert t["scaler"]["scale"].item() == 2.0 ** 15 == j["scaler"]["scale"].item()
    assert t["scaler"]["unskipped"].item() == 0 == j["scaler"]["unskipped"].item()
