"""Port parity: the unfused-attention path of the GPT and BERT O5 training
steps (``use_flash_attention=False``: materialized scores, the causal or
key-padding scaled softmax, ``probs @ v``), held against the JAX package on
the same numpy parameters and batch at a small size, and the port's flash
path against its unfused path.

- GPT (vocab 512, seq 128, d 128, 4 heads, 2 layers, batch 2): the amp O5,
  arena-native FusedAdam step for 3 steps, JAX eager with its Pallas
  unscale and Adam kernels in interpret mode (eager keeps the bf16
  roundings PyTorch keeps; see ``test_torch_training.py``).
- BERT (vocab 512, seq 128, d 64, 4 heads, 2 layers, batch 2, lengths
  [128, 77]): the forward and one O5 FusedLAMB step, JAX under ``jax.jit``
  (eager would re-trace its layer scan every call; see
  ``test_torch_bert.py``).

JAX's softmax dispatches to its jnp path on the CPU (its Pallas kernels are
held against the port in ``test_torch_softmax.py``); the port runs the
kernels' plain versions (CPU tensors). Tolerances, and why, are in PERF.md.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import amp as jamp
from beforeholiday_tpu.optimizers import FusedAdam as JFusedAdam
from beforeholiday_tpu.optimizers import FusedLAMB as JFusedLAMB
from beforeholiday_tpu.testing import bert as jbert
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_paths, tree_unflatten
from beforeholiday_tpu_torch.optimizers import FusedAdam as TFusedAdam
from beforeholiday_tpu_torch.optimizers import FusedLAMB as TFusedLAMB
from beforeholiday_tpu_torch.testing import bert as tbert
from beforeholiday_tpu_torch.testing import gpt as tgpt

GPT_SMALL = dict(vocab_size=512, seq_len=128, d_model=128, n_heads=4, n_layers=2)
BERT_SMALL = dict(vocab_size=512, seq_len=128, d_model=64, n_heads=4, n_layers=2)
LENS = [128, 77]
ADAM_LR, LAMB_LR = 1e-3, 1e-3
STEPS = 3
BF16_ULP = 2.0 ** -7
ACT = {"fp32_act": (jnp.float32, torch.float32),
       "bf16_act": (jnp.bfloat16, torch.bfloat16)}

# per activation dtype, the bounds of test_torch_training.py and
# test_torch_bert.py (PERF.md's tolerance table has the measured values)
TOL = {
    "fp32_act": dict(loss=1e-5, grad_atol=(1e-6, 1e-4), grad_rtol=BF16_ULP,
                     master=1e-4, sq_atol=1e-6),
    "bf16_act": dict(loss=1e-3, grad_atol=(2e-2, 2e-2), grad_rtol=BF16_ULP,
                     master=3e-3, sq_atol=1e-5),
}


def _np(t):
    return t.detach().float().numpy()


def _f32(a):
    return np.asarray(a, dtype=np.float32)


# ------------------------------------------------------------------ GPT


def _gpt_batch(seed=1, batch=2):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, GPT_SMALL["vocab_size"], (batch, GPT_SMALL["seq_len"]))
    return tok.astype(np.int32), np.roll(tok, -1, axis=-1).astype(np.int32)


def _jax_gpt_run(act_dtype):
    cfg = jgpt.GPTConfig(**GPT_SMALL, dtype=act_dtype, use_flash_attention=False)
    params = jgpt.init(jax.random.PRNGKey(0), cfg)
    m = jamp.initialize(lambda p, t: jgpt.forward(p, t, cfg), params,
                        JFusedAdam(lr=ADAM_LR, impl="pallas"), "O5",
                        arena_native=True)
    svag = jamp.scaled_value_and_grad(
        lambda p, tok, tgt: jgpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply),
        m.scaler, impl="pallas")
    p, o, s = m.params, m.optimizer.init(m.params), m.scaler.init()
    tok, tgt = (jnp.asarray(a) for a in _gpt_batch())
    out = []
    for _ in range(STEPS):
        loss, g, fi, s = svag(p, s, tok, tgt)
        p, o = m.optimizer.step(p, g, o, found_inf=fi)
        out.append(jax.tree.map(np.asarray, dict(
            loss=loss, grads=g.arenas, found_inf=fi, opt=o)))
    return jax.tree.map(np.asarray, params), out


def _port_gpt_run(np_params, act_dtype):
    cfg = tgpt.GPTConfig(**GPT_SMALL, dtype=act_dtype, use_flash_attention=False)
    m = tamp.initialize(lambda p, t: tgpt.forward(p, t, cfg),
                        tgpt.params_from_numpy(np_params, device="cpu"),
                        TFusedAdam(lr=ADAM_LR), "O5", arena_native=True)
    svag = tamp.scaled_value_and_grad(
        lambda p, tok, tgt: tgpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply),
        m.scaler)
    o, s = m.optimizer.init(m.params), m.scaler.init(device="cpu")
    tok, tgt = (torch.from_numpy(a).long() for a in _gpt_batch())
    out = []
    for _ in range(STEPS):
        loss, g, fi, s = svag(m.params, s, tok, tgt)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        out.append(dict(loss=loss, grads=[a.clone() for a in g.arenas],
                        found_inf=fi, model=[a.clone() for a in m.params.arenas],
                        master=[a.clone() for a in o["master"]],
                        inner=[{k: v.clone() for k, v in b.items()}
                               for b in o["inner"]]))
    return m, out


@pytest.fixture(scope="module", params=list(ACT))
def gpt_runs(request):
    jdt, tdt = ACT[request.param]
    np_params, jout = _jax_gpt_run(jdt)
    return (request.param, jout, *_port_gpt_run(np_params, tdt))


@pytest.mark.parametrize("step", range(STEPS))
def test_gpt_unfused_step_matches_jax(gpt_runs, step):
    """Loss, found_inf, grad arenas, masters, moments and the model arena
    after each of three steps."""
    name, jout, m, tout = gpt_runs
    tol = TOL[name]
    g_atol = tol["grad_atol"][min(step, 1)]
    j, t = jout[step], tout[step]
    np.testing.assert_allclose(t["loss"].item(), float(j["loss"]), rtol=tol["loss"])
    assert bool(t["found_inf"]) == bool(j["found_inf"]) is False
    for b, (got, ref) in enumerate(zip(t["grads"], j["grads"])):
        _assert_arena_close(m.params, b, got, ref, rtol=tol["grad_rtol"],
                            atol=g_atol, leaf_tol=TOK_EMBED_TOL)
    for b in range(2):
        jo, to = j["opt"]["inner"][b], t["inner"][b]
        assert int(to["step"]) == int(jo["step"]) == step + 1
        # Adam's normalised update turns a grad that flips sign near zero
        # into a 2 lr difference; the bound grows with each step
        np.testing.assert_allclose(_np(t["master"][b]), _f32(j["opt"]["master"][b]),
                                   atol=tol["master"] * (step + 1), rtol=0)
        np.testing.assert_allclose(_np(to["exp_avg"]), _f32(jo["exp_avg"]),
                                   atol=g_atol, rtol=tol["grad_rtol"])
        np.testing.assert_allclose(_np(to["exp_avg_sq"]), _f32(jo["exp_avg_sq"]),
                                   atol=tol["sq_atol"], rtol=2 * tol["grad_rtol"])
        assert torch.equal(t["model"][b], t["master"][b].to(t["model"][b].dtype))


def test_gpt_unfused_loss_falls(gpt_runs):
    losses = [t["loss"].item() for t in gpt_runs[3]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ----------------------------------------------------------------- BERT


def _bert_batch(seed=1, batch=2):
    rng = np.random.default_rng(seed)
    V, S = BERT_SMALL["vocab_size"], BERT_SMALL["seq_len"]
    targets = rng.integers(0, V - 1, (batch, S))
    mask = (rng.random((batch, S)) < 0.15).astype(np.float32)
    tokens = np.where(mask > 0, V - 1, targets)
    nsp = rng.integers(0, 2, (batch,))
    return (tokens.astype(np.int32), targets.astype(np.int32), mask,
            nsp.astype(np.int32), np.asarray(LENS, np.int32))


def _port_bert_batch():
    tok, tgt, mask, nsp, lens = _bert_batch()
    return (torch.from_numpy(tok).long(), torch.from_numpy(tgt).long(),
            torch.from_numpy(mask), torch.from_numpy(nsp).long(),
            torch.from_numpy(lens))


def test_bert_unfused_forward_matches_jax():
    """MLM and NSP logits and the pretraining loss with ragged lengths,
    fp32 throughout."""
    jcfg = jbert.BertConfig(**BERT_SMALL, use_flash_attention=False)
    params = jbert.init(jax.random.PRNGKey(0), jcfg)
    tok, tgt, mask, nsp, lens = (jnp.asarray(a) for a in _bert_batch())
    jmlm, jnsp = jax.jit(functools.partial(jbert.forward, cfg=jcfg))(
        params, tok, seq_lens=lens)
    jloss = jax.jit(functools.partial(jbert.pretrain_loss, cfg=jcfg))(
        params, tok, tgt, mask, nsp, seq_lens=lens)
    cfg = tbert.BertConfig(**BERT_SMALL, use_flash_attention=False)
    tp = tbert.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    ttok, ttgt, tmask, tnsp, tlens = _port_bert_batch()
    mlm, nspl = tbert.forward(tp, ttok, cfg, seq_lens=tlens)
    np.testing.assert_allclose(mlm.numpy(), np.asarray(jmlm), atol=1e-4, rtol=0)
    np.testing.assert_allclose(nspl.numpy(), np.asarray(jnsp), atol=1e-5, rtol=0)
    loss = tbert.pretrain_loss(tp, ttok, ttgt, tmask, tnsp, cfg, seq_lens=tlens)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


def _jax_bert_step(act_dtype):
    cfg = jbert.BertConfig(**BERT_SMALL, dtype=act_dtype, use_flash_attention=False)
    params = jbert.init(jax.random.PRNGKey(0), cfg)
    m = jamp.initialize(lambda p, t: jbert.forward(p, t, cfg), params,
                        JFusedLAMB(lr=LAMB_LR, weight_decay=0.01, impl="pallas"),
                        "O5", arena_native=True)
    tok, tgt, mask, nsp, lens = (jnp.asarray(a) for a in _bert_batch())
    svag = jamp.scaled_value_and_grad(
        lambda pk: jbert.pretrain_loss(pk.unpack(), tok, tgt, mask, nsp, cfg,
                                       seq_lens=lens),
        m.scaler, impl="pallas")

    @jax.jit
    def step(p, o, s):
        loss, g, fi, s = svag(p, s)
        p, o = m.optimizer.step(p, g, o, found_inf=fi)
        return loss, g, fi, o

    loss, g, fi, o = step(m.params, m.optimizer.init(m.params), m.scaler.init())
    return jax.tree.map(np.asarray, params), jax.tree.map(
        np.asarray, dict(loss=loss, grads=g.arenas, found_inf=fi, opt=o))


@pytest.fixture(scope="module", params=list(ACT))
def bert_step(request):
    jdt, tdt = ACT[request.param]
    np_params, j = _jax_bert_step(jdt)
    cfg = tbert.BertConfig(**BERT_SMALL, dtype=tdt, use_flash_attention=False)
    m = tamp.initialize(lambda p, t: tbert.forward(p, t, cfg),
                        tbert.params_from_numpy(np_params, device="cpu"),
                        TFusedLAMB(lr=LAMB_LR, weight_decay=0.01), "O5",
                        arena_native=True)
    tok, tgt, mask, nsp, lens = _port_bert_batch()
    svag = tamp.scaled_value_and_grad(
        lambda pk: tbert.pretrain_loss(pk.unpack(), tok, tgt, mask, nsp, cfg,
                                       seq_lens=lens),
        m.scaler)
    o, s = m.optimizer.init(m.params), m.scaler.init(device="cpu")
    loss, g, fi, s = svag(m.params, s)
    m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
    return request.param, j, m, dict(loss=loss, grads=g.arenas, found_inf=fi, opt=o)


# the (D,) row type_embed[0] is added to every position: its bf16 gradient
# is a sum over B*S rows that XLA's CPU reduce rounds in parts (see
# test_torch_bert.py), up to 1.5% of the leaf's largest gradient apart
TYPE_EMBED_TOL = {("type_embed",): lambda ref, rtol, atol: dict(
    rtol=3e-2, atol=3e-2 * float(np.abs(ref).max()))}
# GPT's tied embedding: its bf16 gradient is the sum of two bf16-rounded
# terms (the gathered rows' and the vocab head's), rounded again, in each
# package's own order: twice the relative bound of the other leaves
TOK_EMBED_TOL = {("tok_embed",): lambda ref, rtol, atol: dict(rtol=2 * rtol, atol=atol)}


def _assert_arena_close(packed, b, got, ref, *, rtol, atol, leaf_tol=None):
    """Arena ``b`` of the port against JAX's, leaf by leaf: the leaves in
    ``leaf_tol`` (path -> tolerance from the reference slice, ``rtol`` and
    ``atol``) within theirs, every other leaf within ``rtol``/``atol``."""
    got, ref = _np(got), _f32(ref)
    lay, paths = packed.layout, tree_paths(packed.unpack())
    for i, off, shape in zip(lay.indices[b], lay.specs[b].offsets, lay.specs[b].shapes):
        sl = slice(off, off + int(np.prod(shape)))
        leaf = (leaf_tol or {}).get(paths[i])
        tol = leaf(ref[sl], rtol, atol) if leaf else dict(rtol=rtol, atol=atol)
        np.testing.assert_allclose(got[sl], ref[sl], err_msg=str(paths[i]), **tol)


def test_bert_unfused_lamb_step_matches_jax(bert_step):
    """Loss, found_inf, grad arenas, masters and moments after one O5
    FusedLAMB step with ragged lengths."""
    name, j, m, t = bert_step
    tol = TOL[name]
    g_atol = tol["grad_atol"][0]
    np.testing.assert_allclose(t["loss"].item(), float(j["loss"]), rtol=tol["loss"])
    assert bool(t["found_inf"]) == bool(j["found_inf"]) is False
    for b, (got, ref) in enumerate(zip(t["grads"], j["grads"])):
        _assert_arena_close(m.params, b, got, ref, rtol=tol["grad_rtol"],
                            atol=g_atol, leaf_tol=TYPE_EMBED_TOL)
    for b in range(2):
        jo, to = j["opt"]["inner"][b], t["opt"]["inner"][b]
        assert int(to["step"]) == int(jo["step"]) == 1
        np.testing.assert_allclose(_np(t["opt"]["master"][b]),
                                   _f32(j["opt"]["master"][b]),
                                   atol=tol["master"], rtol=0)
        _assert_arena_close(m.params, b, to["exp_avg"], jo["exp_avg"],
                            rtol=tol["grad_rtol"], atol=g_atol,
                            leaf_tol=TYPE_EMBED_TOL)
        _assert_arena_close(m.params, b, to["exp_avg_sq"], jo["exp_avg_sq"],
                            rtol=2 * tol["grad_rtol"], atol=tol["sq_atol"],
                            leaf_tol=TYPE_EMBED_TOL)


# ------------------------------------------------- port flash vs unfused


def _loss_and_grads(loss_fn, params):
    leaves, treedef = tree_flatten(params)
    leaves = [p.clone().requires_grad_(True) for p in leaves]
    loss = loss_fn(tree_unflatten(treedef, leaves))
    return loss.item(), torch.autograd.grad(loss, leaves)


def test_gpt_flash_matches_unfused():
    """The port's own version of ``tests/test_gpt_flagship.py``
    ``test_flash_matches_unfused``: flash attention (K2/K4's plain versions)
    and the materialized causal softmax give the same loss and gradients."""
    cfg = tgpt.GPTConfig(**GPT_SMALL)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok, tgt = (torch.from_numpy(a).long() for a in _gpt_batch())
    out = {}
    for flash in (True, False):
        c = tgpt.GPTConfig(**GPT_SMALL, use_flash_attention=flash)
        out[flash] = _loss_and_grads(lambda p: tgpt.loss_fn(p, tok, tgt, c), params)
    (lf, gf), (lu, gu) = out[True], out[False]
    np.testing.assert_allclose(lf, lu, rtol=1e-5)
    for a, b in zip(gf, gu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-4)


def test_bert_flash_matches_unfused():
    """Bidirectional flash with ``kv_lens`` and the key-padding scaled
    softmax give the same pretraining loss and gradients, ragged lengths
    included."""
    cfg = tbert.BertConfig(**BERT_SMALL)
    params = tbert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok, tgt, mask, nsp, lens = _port_bert_batch()
    out = {}
    for flash in (True, False):
        c = tbert.BertConfig(**BERT_SMALL, use_flash_attention=flash)
        out[flash] = _loss_and_grads(
            lambda p: tbert.pretrain_loss(p, tok, tgt, mask, nsp, c, seq_lens=lens),
            params)
    (lf, gf), (lu, gu) = out[True], out[False]
    np.testing.assert_allclose(lf, lu, rtol=1e-5)
    for a, b in zip(gf, gu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-4)
