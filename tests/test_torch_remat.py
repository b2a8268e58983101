"""Port parity: the remat policies (``beforeholiday_tpu_torch.remat``)
through the GPT, BERT and the pipeline schedules, held against the JAX
package's ``tests/test_remat.py`` at its own bounds (fp32: loss rtol 1e-6,
grads rtol 1e-5, atol 1e-6), and the port's remat against its own no-remat
run, bitwise: a recompute runs the same ops on the same inputs. The JAX
reference is one run per model without remat, shared by the policies:
``tests/test_remat.py`` holds JAX's remat steps to that run at the same
bounds (at these sizes the GPT's are bitwise it, BERT's within 3e-9). The
1F1B engine's remat cases run in ``tests/test_torch_pipeline_parallel.py``'s
gloo world (one spawn for the file's cases).

Also the memory ledger's CPU reading (the bytes kept for the backward)
ordered as remat promises: ``full`` <= ``dots_saveable`` <= ``none`` and
``save_boundaries`` < ``none``; and the launches each policy repeats,
counted on the kernels' plain versions.
"""

import functools
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu import remat as jremat  # noqa: E402
from beforeholiday_tpu.testing import bert as jbert  # noqa: E402
from beforeholiday_tpu.testing import gpt as jgpt  # noqa: E402
from beforeholiday_tpu.transformer import pipeline_parallel as jpp  # noqa: E402
from beforeholiday_tpu_torch import monitor as tmon  # noqa: E402
from beforeholiday_tpu_torch import remat  # noqa: E402
from beforeholiday_tpu_torch.ops import attention as tattn  # noqa: E402
from beforeholiday_tpu_torch.ops import normalization as tnorm  # noqa: E402
from beforeholiday_tpu_torch.testing import bert as tbert  # noqa: E402
from beforeholiday_tpu_torch.testing import gpt as tgpt  # noqa: E402
from beforeholiday_tpu_torch.transformer import pipeline_parallel as tpp  # noqa: E402
from beforeholiday_tpu_torch.transformer.tensor_parallel import random as trandom  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
POLICIES = ("full", "dots_saveable", "save_boundaries")
TINY = dict(vocab_size=257, seq_len=32, d_model=64, n_heads=2, n_layers=2)
LOSS_RTOL, GRAD_TOL = 1e-6, dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ registry


class TestPolicyRegistry:
    def test_builtins_and_tags_are_jaxs(self):
        assert set(jremat.available_policies()) <= set(remat.available_policies())
        assert remat.BOUNDARY_TAGS == jremat.BOUNDARY_TAGS
        assert remat.ZERO3_GATHERED_TAG == jremat.policies.ZERO3_GATHERED_TAG
        for tag in ("TAG_BLOCK", "TAG_NORM_OUT", "TAG_ATTN_OUT", "TAG_FLASH_LSE",
                    "TAG_MOE_DISPATCH", "TAG_MOE_COMBINE"):
            assert getattr(remat, tag) == getattr(jremat.policies, tag)

    def test_unknown_policy_raises(self):
        with pytest.raises(ValueError, match="unknown remat policy"):
            remat.resolve("no_such_policy")
        with pytest.raises(ValueError, match="unknown remat policy"):
            remat.apply(lambda x: x, "no_such_policy")

    def test_duplicate_registration_raises(self):
        with pytest.raises(ValueError, match="already registered"):
            remat.register_policy("full", None)
        remat.register_policy("full", None, overwrite=True)

    def test_none_is_identity_wrap(self):
        fn = lambda x: x * 2  # noqa: E731
        assert remat.apply(fn, None) is fn
        assert remat.apply(fn, "none") is fn

    def test_custom_policy_round_trips(self):
        name = "test_custom_tags"
        if name not in remat.available_policies():
            remat.register_policy(name, remat.Policy(names=remat.BOUNDARY_TAGS[:1]))
        wrapped = remat.apply(lambda x: torch.sin(x) * 2, name)
        x = torch.arange(4.0, requires_grad=True)
        (g,) = torch.autograd.grad(wrapped(x).sum(), x)
        assert torch.equal(g, torch.cos(x.detach()) * 2)

    def test_non_string_policy_passes_through(self):
        pol = remat.Policy(ops=remat.policies.DOT_OPS)
        assert remat.resolve(pol) is pol
        ops = [torch.ops.aten.mm.default]
        assert remat.resolve(ops) is ops

    def test_dots_saveable_saves_every_product_overload(self):
        """The card's bf16 x bf16 -> fp32 GEMMs are mm's and addmm's
        ``.dtype`` overloads: saved as the default overloads are."""
        pol = remat.resolve("dots_saveable")
        aten = torch.ops.aten
        for op in (aten.mm.default, aten.mm.dtype, aten.addmm.default,
                   aten.addmm.dtype, aten.bmm.default, aten._scaled_mm.default):
            assert pol.saves(op, ()), op
        assert not pol.saves(aten.add.Tensor, ())
        assert not pol.saves(torch.ops.beforeholiday.flash_fwd.default, ())

    def test_checkpoint_name_is_identity_outside_a_region(self):
        x = torch.ones(3)
        assert remat.checkpoint_name(x, remat.TAG_BLOCK) is x

    def test_scan_covers_the_slice_modules(self):
        """The AST scan of tests/test_torch_serving.py globs the package:
        these modules are in it."""
        for path in ("remat/__init__.py", "remat/policies.py", "monitor/metrics.py",
                     "monitor/export.py", "monitor/memory.py", "monitor/roofline.py",
                     "monitor/overlap.py", "monitor/goodput.py",
                     "monitor/counters.py", "utils/profiling.py", "utils/timers.py"):
            assert (REPO / "beforeholiday_tpu_torch" / path).is_file(), path


# ------------------------------------------------------------------ the GPT


def _tree_pairs(jtree, ttree):
    """``(path, jax leaf, torch leaf)`` over the JAX tree's leaves."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for key in path:
            node = node[key.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), node


def _leaf_params(tparams):
    """Fresh leaves that require grad, in the same nesting."""
    return {k: _leaf_params(v) if isinstance(v, dict) else
            v.detach().clone().requires_grad_() for k, v in tparams.items()}


def _grads(p):
    return {k: _grads(v) if isinstance(v, dict) else v.grad for k, v in p.items()}


def _assert_close(name, jgrads, tgrads):
    for path, want, got in _tree_pairs(jgrads, tgrads):
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{name} {path}",
                                   **GRAD_TOL)


def _assert_bitwise(name, a, b, path=""):
    for k, v in a.items():
        if isinstance(v, dict):
            _assert_bitwise(name, v, b[k], f"{path}/{k}")
        else:
            assert torch.equal(v, b[k]), f"{name} {path}/{k}"


@pytest.fixture(scope="module")
def gpt_model():
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    tokens, targets = jgpt.synthetic_batch(jax.random.PRNGKey(1), jcfg, 2)
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jparams, tokens, targets, tparams,
            torch.from_numpy(np.array(tokens)).long(),
            torch.from_numpy(np.array(targets)).long())


def _port_gpt(tparams, tok, tgt, policy, dropout_key=None, **cfg_kw):
    cfg = tgpt.GPTConfig(**TINY, remat_policy=policy, **cfg_kw)
    p = _leaf_params(tparams)
    if dropout_key is None:
        loss = tgpt.loss_fn(p, tok, tgt, cfg)
    else:
        loss, _ = tgpt.loss_and_aux(p, tok, tgt, cfg, dropout_key=dropout_key)
    loss.backward()
    return loss.detach(), _grads(p)


@pytest.fixture(scope="module")
def gpt_none(gpt_model):
    _, _, _, tparams, tok, tgt = gpt_model
    return _port_gpt(tparams, tok, tgt, None)


@pytest.fixture(scope="module")
def gpt_jax(gpt_model):
    """JAX's loss and gradients, once for every policy."""
    jparams, tokens, targets = gpt_model[:3]
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    return jax.jit(jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, tokens, targets, jcfg)))(jparams)


@pytest.mark.parametrize("policy", POLICIES)
def test_gpt_loss_and_grads_match_jax(gpt_model, gpt_none, gpt_jax, policy):
    """JAX's loss and gradients at JAX's bounds; and bitwise the port's
    no-remat step."""
    tparams, tok, tgt = gpt_model[3:]
    jloss, jgrads = gpt_jax
    loss, grads = _port_gpt(tparams, tok, tgt, policy)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_close(policy, jgrads, grads)
    assert torch.equal(loss, gpt_none[0])
    _assert_bitwise(policy, grads, gpt_none[1])


@pytest.mark.parametrize("policy", ("full", "save_boundaries"))
def test_gpt_dropout_path_replays_the_masks(gpt_model, policy):
    """Remat under dropout replays the same masks in the recompute (the
    layer keys are the block's inputs): loss and gradients bitwise the
    no-remat dropout step's (JAX's witness is the same equality)."""
    _, _, _, tparams, tok, tgt = gpt_model
    key = trandom.make_key(7, device="cpu")
    kw = dict(dropout_rate=0.1, attention_dropout=0.1)
    ref = _port_gpt(tparams, tok, tgt, None, key, **kw)
    got = _port_gpt(tparams, tok, tgt, policy, key, **kw)
    assert torch.equal(got[0], ref[0])
    _assert_bitwise(policy, got[1], ref[1])


def test_gpt_zero3_regather_and_unfused_paths_are_bitwise(gpt_model, gpt_none):
    """``zero3_regather`` (everything saved but the gathered params, which
    the GPT does not tag) and the unfused attention under a selective
    policy reproduce the plain steps bitwise."""
    _, _, _, tparams, tok, tgt = gpt_model
    got = _port_gpt(tparams, tok, tgt, "zero3_regather")
    assert torch.equal(got[0], gpt_none[0])
    _assert_bitwise("zero3_regather", got[1], gpt_none[1])
    ref = _port_gpt(tparams, tok, tgt, None, use_flash_attention=False)
    got = _port_gpt(tparams, tok, tgt, "dots_saveable", use_flash_attention=False)
    assert torch.equal(got[0], ref[0])
    _assert_bitwise("unfused", got[1], ref[1])


def _counting(monkeypatch, names):
    """Counts the calls of the kernels' plain versions (the CPU path)."""
    counts = dict.fromkeys(names, 0)
    for mod, name in ((tattn, "flash_fwd_torch"), (tattn, "flash_bwd_torch"),
                      (tnorm, "ln_fwd_torch"), (tnorm, "ln_bwd_torch")):
        if name in names:
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                counts[_name] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, wrapped)
    return counts


@pytest.mark.parametrize("policy, fwd, norm", [
    (None, 2, 5), ("full", 4, 9), ("dots_saveable", 4, 9), ("save_boundaries", 2, 5)])
def test_gpt_launches_each_policy_repeats(gpt_model, monkeypatch, policy, fwd, norm):
    """The recompute repeats K2 and K1 under ``full`` and ``dots_saveable``
    (two layers: K2 2 -> 4, K1 5 -> 9) and skips both under
    ``save_boundaries``, which saves their outputs (the norm output and the
    attention context with its lse); K3 and K4 run once."""
    _, _, _, tparams, tok, tgt = gpt_model
    counts = _counting(monkeypatch, ("flash_fwd_torch", "flash_bwd_torch",
                                     "ln_fwd_torch", "ln_bwd_torch"))
    _port_gpt(tparams, tok, tgt, policy)
    assert counts == {"flash_fwd_torch": fwd, "flash_bwd_torch": 2,
                      "ln_fwd_torch": norm, "ln_bwd_torch": 5}


class _GemmCount(TorchDispatchMode):
    """Counts the GEMMs dispatched in its scope, the backward's and the
    recompute's included."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in ("mm", "addmm", "bmm", "baddbmm", "matmul",
                                            "_scaled_mm"):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _gemms(gpt_model, policy):
    tparams, tok, tgt = gpt_model[3:]
    with _GemmCount() as mode:
        _port_gpt(tparams, tok, tgt, policy)
    return mode.n


@pytest.fixture(scope="module")
def gpt_none_gemms(gpt_model):
    return _gemms(gpt_model, None)


@pytest.mark.parametrize("policy, recomputed", [
    (None, 0), ("full", 6), ("dots_saveable", 0), ("save_boundaries", 6)])
def test_gpt_gemms_each_policy_recomputes(gpt_model, gpt_none_gemms, policy,
                                          recomputed):
    """``dots_saveable`` saves every product, so its backward runs no GEMM
    beyond the no-remat step's; ``full`` and ``save_boundaries`` run each
    block's first three again (the recompute stops before the last, whose
    output no backward needs): 3 a block, two blocks."""
    n = _gemms(gpt_model, policy)
    assert n - gpt_none_gemms == recomputed, (n, gpt_none_gemms)


def test_memory_ledger_orders_the_policies(gpt_model):
    """The CPU reading (bytes kept for the backward): full <= dots_saveable
    <= none, and save_boundaries < none."""
    _, _, _, tparams, tok, tgt = gpt_model
    tmon.reset_memory_ledger()
    got = {}
    for policy in ("none", *POLICIES):
        cfg = tgpt.GPTConfig(**TINY, remat_policy=policy)
        p = _leaf_params(tparams)
        step = tmon.track_memory(f"gpt_{policy}")(
            lambda t, y, p=p, cfg=cfg: tgpt.loss_fn(p, t, y, cfg).backward())
        step(tok, tgt)
        rec = tmon.memory_records()[f"gpt_{policy}"]
        assert rec["calls"] == 1 and rec["signatures"][0]["method"] == "saved_tensors"
        got[policy] = rec["signatures"][0]["temp_bytes"]
    tmon.reset_memory_ledger()
    assert got["full"] <= got["dots_saveable"] <= got["none"], got
    assert got["save_boundaries"] < got["none"], got
    assert got["full"] > 0


# ------------------------------------------------------------------ BERT


@pytest.fixture(scope="module")
def bert_model():
    """JAX's MLM + NSP loss and gradients (once for every policy), and the
    port's inputs from the same numpy values."""
    jcfg = jbert.BertConfig(**TINY, dtype=jnp.float32)
    jparams = jbert.init(jax.random.PRNGKey(0), jcfg)
    tokens, targets, mlm_mask, _ = jbert.synthetic_batch(jax.random.PRNGKey(1), jcfg, 2)

    def jloss(p):
        mlm, nsp = jbert.forward(p, tokens, jcfg)
        logp = jax.nn.log_softmax(mlm.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * mlm_mask) / jnp.sum(mlm_mask) + jnp.mean(
            nsp.astype(jnp.float32) ** 2)

    ref = jax.jit(jax.value_and_grad(jloss))(jparams)
    tparams = tbert.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (ref, tparams, torch.from_numpy(np.array(tokens)).long(),
            torch.from_numpy(np.array(targets)).long(),
            torch.from_numpy(np.array(mlm_mask)))


@pytest.mark.parametrize("policy", POLICIES)
def test_bert_mlm_logits_grads_match_jax(bert_model, policy):
    ref, tparams, tok, tgt, mask = bert_model

    def tloss(pol):
        p = _leaf_params(tparams)
        mlm, nsp = tbert.forward(p, tok, tbert.BertConfig(**TINY, remat_policy=pol))
        logp = torch.log_softmax(mlm.float(), dim=-1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        loss = (nll * mask).sum() / mask.sum() + (nsp.float() ** 2).mean()
        loss.backward()
        return loss.detach(), _grads(p)

    loss, grads = tloss(policy)
    np.testing.assert_allclose(float(loss), float(ref[0]), rtol=LOSS_RTOL)
    _assert_close(policy, ref[1], grads)
    base = tloss(None)
    assert torch.equal(loss, base[0])
    _assert_bitwise(policy, grads, base[1])


def test_random_checkpoint_takes_a_policy_name():
    """``tensor_parallel.random.checkpoint(policy=)``: a name goes through
    ``remat.apply``; None recomputes everything."""
    w = torch.randn(4, 4, requires_grad=True)
    fn = lambda x: torch.tanh(x @ w) @ w  # noqa: E731
    x = torch.randn(3, 4)
    want = torch.autograd.grad(fn(x).sum(), w)[0]
    for policy in (None, "dots_saveable", "save_boundaries"):
        got = torch.autograd.grad(trandom.checkpoint(fn, policy=policy)(x).sum(), w)[0]
        assert torch.equal(got, want), policy


# ------------------------------------------------------------ the schedules

HIDDEN, MICRO, M, S = 8, 4, 6, 4


def _stage(sp, x):
    return jax.nn.gelu(x @ sp["w"] + sp["b"]) + x


def _loss(y, tgt):
    return jnp.mean((y - tgt) ** 2)


def _pipe_data():
    rng = np.random.default_rng(1)
    stacked = {"w": (rng.standard_normal((S, HIDDEN, HIDDEN)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal((S, HIDDEN)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((M, MICRO, HIDDEN)).astype(np.float32)
    y = rng.standard_normal((M, MICRO, HIDDEN)).astype(np.float32)
    return stacked, x, y


@functools.cache
def _jax_no_pipelining():
    """JAX's engine without remat on ``_pipe_data``, once for every policy."""
    stacked, x, y = _pipe_data()

    def full_model(st, a):
        return jax.lax.scan(lambda h, sp: (_stage(sp, h), None), a, st)[0]

    return jax.jit(functools.partial(
        jpp.forward_backward_no_pipelining, full_model, _loss))(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(x), jnp.asarray(y))


@pytest.mark.parametrize("policy", POLICIES)
def test_no_pipelining_remat_matches_jax(policy):
    stacked, x, y = _pipe_data()
    jl, jg = _jax_no_pipelining()

    def stage(st, a):
        for i in range(S):
            a = tw._toy_stage({k: v[i] for k, v in st.items()}, a)
        return a

    run = functools.partial(tpp.forward_backward_no_pipelining, stage, tw._toy_loss,
                            {k: torch.from_numpy(v) for k, v in stacked.items()},
                            torch.from_numpy(x), torch.from_numpy(y))
    tl, tg = run(remat_policy=policy)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)
    bl, bg = run()
    assert torch.equal(tl, bl) and all(torch.equal(tg[k], bg[k]) for k in ("w", "b"))
