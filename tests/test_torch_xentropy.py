"""Port parity: the fused label-smoothing cross entropy
(``beforeholiday_tpu_torch.contrib.softmax_cross_entropy_loss``, kernels
K14/K15) held against ``beforeholiday_tpu.contrib.softmax_cross_entropy_loss``
on the same numpy inputs: the function and its gradient against JAX's
Pallas kernels (interpret mode, as ``tests/test_contrib_losses.py`` runs
them) and its jnp path; then the flagship GPT's and BERT's amp O5
arena-native steps with this loss, as a user script composes them (GPT:
smoothing 0.1, padding index 0 with the first 32 targets padded; BERT: the
MLM term over ``where(mask, targets, [MASK])`` with ``padding_idx`` [MASK],
smoothing 0, plus the NSP term), against the same composition in the JAX
package for 3 steps at a small size (vocab 256, seq 128, d 64, 4 heads, 2
layers, batch 2).

The port runs the kernels' plain versions (CPU tensors). Tolerances, and
why, are in PERF.md.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import amp as jamp
from beforeholiday_tpu.contrib import softmax_cross_entropy_loss as jxent
from beforeholiday_tpu.contrib import xentropy as jxmod
from beforeholiday_tpu.optimizers import FusedAdam as JFusedAdam
from beforeholiday_tpu.optimizers import FusedLAMB as JFusedLAMB
from beforeholiday_tpu.testing import bert as jbert
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.contrib import softmax_cross_entropy_loss as txent
from beforeholiday_tpu_torch.contrib import xentropy as txmod
from beforeholiday_tpu_torch.ops.arena import tree_paths
from beforeholiday_tpu_torch.optimizers import FusedAdam as TFusedAdam
from beforeholiday_tpu_torch.optimizers import FusedLAMB as TFusedLAMB
from beforeholiday_tpu_torch.testing import bert as tbert
from beforeholiday_tpu_torch.testing import gpt as tgpt

# JAX's own bound for this function (tests/test_contrib_losses.py)
FP32_TOL = dict(atol=2e-5, rtol=2e-5)
# half types: the same fp32 value rounded once, so one ulp apart at most:
# the spacing relative to the value, and fp16's subnormal step
HALF_TOL = {torch.bfloat16: dict(rtol=2 ** -7, atol=0.0),
            torch.float16: dict(rtol=2 ** -10, atol=2 ** -24)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}


def _inputs(N, V, seed, pad_rows=(0, 3)):
    """Seeded logits (std 2), labels in [1, V) with ``pad_rows`` set to the
    padding index 0, and a cotangent per row."""
    rng = np.random.default_rng(seed)
    x = (2 * rng.standard_normal((N, V))).astype(np.float32)
    lab = rng.integers(1, V, N)
    lab[list(pad_rows)] = 0
    return x, lab, rng.standard_normal(N).astype(np.float32)


def _jax(x, lab, w, impl, dtype=torch.float32, **kw):
    """JAX's per-row loss and the gradient of ``sum(w * loss)``, as fp32
    numpy."""
    labj = jnp.asarray(lab, jnp.int32)
    loss, vjp = jax.vjp(lambda xx: jxent(xx, labj, impl=impl, **kw),
                        jnp.asarray(x).astype(JAX_DTYPE[dtype]))
    (g,) = vjp(jnp.asarray(w).astype(loss.dtype))
    return loss, np.asarray(loss.astype(jnp.float32)), np.asarray(g.astype(jnp.float32))


def _port(x, lab, w, dtype=torch.float32, lab_dtype=torch.int64, **kw):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    loss = txent(xt, torch.from_numpy(lab).to(lab_dtype), **kw)
    loss.backward(torch.from_numpy(w).to(loss.dtype))
    return loss, xt.grad


def _f32(t):
    return t.detach().float().numpy()


# -------------------------------------------------------------- function


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.2])
@pytest.mark.parametrize("N, V", [(11, 96), (24, 384)])
def test_matches_jax_fp32(impl, smoothing, N, V):
    """Loss and gradient, fp32; the padded rows exactly 0 in both packages."""
    x, lab, w = _inputs(N, V, seed=N + V)
    _, jl, jg = _jax(x, lab, w, impl, smoothing=smoothing)
    loss, g = _port(x, lab, w, smoothing=smoothing)
    assert loss.dtype == g.dtype == torch.float32 and loss.shape == (N,)
    np.testing.assert_allclose(_f32(loss), jl, **FP32_TOL)
    np.testing.assert_allclose(_f32(g), jg, **FP32_TOL)
    pad = lab == 0
    assert np.all(_f32(loss)[pad] == 0) and np.all(jl[pad] == 0)
    assert np.all(_f32(g)[pad] == 0) and np.all(jg[pad] == 0)
    assert np.all(_f32(g)[~pad] != 0)


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("half_to_float", [False, True])
def test_half_types_within_one_ulp(impl, dtype, half_to_float):
    """N 11 x V 96 in bf16 and fp16: losses in the logits' dtype (or fp32
    under ``half_to_float``) and dx in the logits' dtype, each one rounding
    of the same fp32 value."""
    x, lab, w = _inputs(11, 96, seed=5)
    jloss, jl, jg = _jax(x, lab, w, impl, dtype, smoothing=0.1,
                         half_to_float=half_to_float)
    loss, g = _port(x, lab, w, dtype, smoothing=0.1, half_to_float=half_to_float)
    out = torch.float32 if half_to_float else dtype
    assert loss.dtype == out and str(jloss.dtype) == str(out)[6:]
    assert g.dtype == dtype
    np.testing.assert_allclose(_f32(loss), jl,
                               **(FP32_TOL if half_to_float else HALF_TOL[dtype]))
    np.testing.assert_allclose(_f32(g), jg, **HALF_TOL[dtype])
    assert np.all(_f32(g)[lab == 0] == 0)


@pytest.mark.parametrize("lab_dtype", [torch.int64, torch.int32, torch.int16,
                                       torch.uint8])
def test_any_integer_label_dtype(lab_dtype):
    x, lab, w = _inputs(11, 96, seed=6)
    _, jl, jg = _jax(x, lab, w, "jnp", smoothing=0.1)
    loss, g = _port(x, lab, w, lab_dtype=lab_dtype, smoothing=0.1)
    np.testing.assert_allclose(_f32(loss), jl, **FP32_TOL)
    np.testing.assert_allclose(_f32(g), jg, **FP32_TOL)


@pytest.mark.parametrize("padding_idx", [5, -100])
def test_other_padding_index(padding_idx):
    """A padding index that is a real class, and one outside [0, V) as
    PyTorch's ``ignore_index`` default is: those rows give 0."""
    x, lab, w = _inputs(11, 96, seed=7, pad_rows=())
    lab[[1, 4]] = padding_idx
    _, jl, jg = _jax(x, lab, w, "jnp", smoothing=0.1, padding_idx=padding_idx)
    loss, g = _port(x, lab, w, smoothing=0.1, padding_idx=padding_idx)
    np.testing.assert_allclose(_f32(loss), jl, **FP32_TOL)
    np.testing.assert_allclose(_f32(g), jg, **FP32_TOL)
    assert np.all(_f32(loss)[[1, 4]] == 0) and np.all(_f32(g)[[1, 4]] == 0)


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_plain_versions_match_the_jax_kernels(impl, smoothing):
    """``xent_fwd_torch``/``xent_bwd_torch`` (K14/K15's plain versions, the
    yardsticks on the card) against JAX's ``_fwd_pallas``/``_bwd_pallas``
    (interpret) and ``_fwd_jnp``/``_bwd_jnp``: loss, lse, and dx from the
    same lse and dy, no padding applied."""
    x, lab, w = _inputs(13, 200, seed=8)
    xj, labj = jnp.asarray(x), jnp.asarray(lab, jnp.int32)
    if impl == "pallas":
        jl, jlse = jxmod._fwd_pallas(xj, labj, smoothing, True)
        jdx = jxmod._bwd_pallas(xj, labj, jlse, jnp.asarray(w), smoothing, True)
    else:
        jl, jlse = jxmod._fwd_jnp(xj, labj, smoothing)
        jdx = jxmod._bwd_jnp(xj, labj, jlse, jnp.asarray(w), smoothing)
    xt, labt = torch.from_numpy(x), torch.from_numpy(lab)
    loss, lse = txmod.xent_fwd_torch(xt, labt, smoothing)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), **FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FP32_TOL)
    dx = txmod.xent_bwd_torch(xt, labt, torch.from_numpy(np.array(jlse)),
                              torch.from_numpy(w), smoothing)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **FP32_TOL)


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_tpu_checks_laws(impl):
    """``testing/tpu_checks.py``'s cross-entropy laws at their shape (512 x
    2048, the first 32 rows padded, smoothing 0.1): value and gradient of
    the summed loss within 1e-4 and 1e-3 of JAX's largest value, and within
    JAX's own test bounds elementwise."""
    x, lab, _ = _inputs(512, 2048, seed=9, pad_rows=range(32))
    w = np.ones(512, np.float32)
    jloss, _, jg = _jax(x, lab, w, impl, smoothing=0.1)
    loss, g = _port(x, lab, w, smoothing=0.1)
    jv, v = float(jnp.sum(jloss)), float(loss.detach().sum())

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))

    assert rel(v, jv) < 1e-4 and rel(_f32(g), jg) < 1e-3
    np.testing.assert_allclose(v, jv, rtol=2e-5)
    np.testing.assert_allclose(_f32(g), jg, **FP32_TOL)
    assert np.all(_f32(g)[:32] == 0) and np.all(_f32(loss)[:32] == 0)


def test_shape_validation():
    for logits, labels in ((torch.ones(4, 8, 2), torch.zeros(4, dtype=torch.long)),
                           (torch.ones(4, 8), torch.zeros(4, 1, dtype=torch.long)),
                           (torch.ones(4, 8), torch.zeros(3, dtype=torch.long))):
        with pytest.raises(ValueError, match="expected logits"):
            txent(logits, labels)


def test_tag_and_dispatch():
    """The ``float_function`` tag; CPU tensors take the plain versions and
    launch nothing; ``impl="kernel"`` on CPU tensors and an unknown impl
    raise; the kernel wrappers refuse CPU tensors."""
    assert txent.__amp_list__ == "float"
    x, lab, w = _inputs(11, 96, seed=10)
    before = (txmod.xent_fwd_kernel.launches, txmod.xent_bwd_kernel.launches)
    _port(x, lab, w, smoothing=0.1)
    assert (txmod.xent_fwd_kernel.launches, txmod.xent_bwd_kernel.launches) == before
    xt, labt = torch.from_numpy(x), torch.from_numpy(lab)
    for impl in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="impl"):
            txent(xt, labt, impl=impl)
    with pytest.raises(ValueError, match="K14"):
        txmod.xent_fwd_kernel(xt, labt, 0.1)
    with pytest.raises(ValueError, match="K15"):
        txmod.xent_bwd_kernel(xt, labt, labt.float(), labt.float(), 0.1)


# ------------------------------------------------- the steps with this loss

STEPS = 3
BF16_ULP = 2.0 ** -7
SMALL = dict(vocab_size=256, seq_len=128, d_model=64, n_heads=4, n_layers=2)
SMOOTHING = 0.1  # the GPT step's: the Transformer's label smoothing
PADDED = 32      # targets set to the padding index 0 at the batch's start
LENS = [128, 77]
# the step rows of PERF.md's tolerance table (tests/test_torch_training.py,
# tests/test_torch_bert.py): fp32 activations hold the same fp32 values
# rounded once at step 1; bf16 activations round at other places
TOL = {
    "gpt": {"fp32_act": dict(loss=1e-5, grad_atol=(1e-6, 1e-4), master=1e-4),
            "bf16_act": dict(loss=1e-3, grad_atol=(2e-3, 1e-2), master=3e-3)},
    "bert": {"fp32_act": dict(loss=1e-5, grad_atol=(1e-6, 1e-4), master=1e-4),
             "bf16_act": dict(loss=1e-3, grad_atol=(5e-3, 5e-3), master=3e-3)},
}
# BERT's type_embed[0] gradient is a bf16 sum over B*S cotangents that XLA
# rounds in parts (tests/test_torch_bert.py TYPE_EMBED_TOL)
TYPE_EMBED_TOL = 3e-2
LR = 1e-3


def _gpt_batch(seed=1, batch=2):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, SMALL["vocab_size"], (batch, SMALL["seq_len"]))
    tgt = np.roll(tok, -1, axis=-1)
    tgt.reshape(-1)[:PADDED] = 0
    return tok.astype(np.int32), tgt.astype(np.int32)


def _bert_batch(seed=1, batch=2):
    rng = np.random.default_rng(seed)
    V, S = SMALL["vocab_size"], SMALL["seq_len"]
    targets = rng.integers(0, V - 1, (batch, S))
    mask = (rng.random((batch, S)) < 0.15).astype(np.float32)
    tokens = np.where(mask > 0, V - 1, targets)
    nsp = rng.integers(0, 2, (batch,))
    return (tokens.astype(np.int32), targets.astype(np.int32), mask,
            nsp.astype(np.int32), np.asarray(LENS, np.int32))


def jax_gpt_xent_loss(logits, tgt):
    V = logits.shape[-1]
    per = jxent(logits.reshape(-1, V), tgt.reshape(-1), smoothing=SMOOTHING,
                padding_idx=0, impl="pallas")
    return jnp.sum(per) / jnp.maximum(jnp.sum(tgt != 0), 1)


def port_gpt_xent_loss(logits, tgt):
    V = logits.shape[-1]
    per = txent(logits.reshape(-1, V), tgt.reshape(-1), smoothing=SMOOTHING,
                padding_idx=0)
    return per.sum() / torch.clamp((tgt != 0).sum(), min=1)


def jax_bert_xent_loss(mlm, nsp, tgt, mask, nsp_labels, mask_id):
    V = mlm.shape[-1]
    labels = jnp.where(mask > 0, tgt, mask_id).reshape(-1)
    per = jxent(mlm.reshape(-1, V), labels, padding_idx=mask_id, impl="pallas")
    mlm_loss = jnp.sum(per) / jnp.maximum(jnp.sum(mask), 1.0)
    nsp_logz = jax.nn.logsumexp(nsp, axis=-1)
    nsp_tgt = jnp.take_along_axis(nsp, nsp_labels[:, None], axis=-1)[:, 0]
    return mlm_loss + jnp.mean(nsp_logz - nsp_tgt)


def port_bert_xent_loss(mlm, nsp, tgt, mask, nsp_labels, mask_id):
    V = mlm.shape[-1]
    labels = torch.where(mask > 0, tgt, mask_id).reshape(-1)
    per = txent(mlm.reshape(-1, V), labels, padding_idx=mask_id)
    mlm_loss = per.sum() / torch.clamp(mask.sum(), min=1.0)
    nsp_logz = torch.logsumexp(nsp, dim=-1)
    nsp_tgt = nsp.gather(-1, nsp_labels[:, None])[:, 0]
    return mlm_loss + (nsp_logz - nsp_tgt).mean()


def _jax_run(model, act_dtype):
    """3 O5 steps of the JAX composition: FusedAdam for GPT (eager, as the
    port runs, with the Pallas flash attention in interpret mode), FusedLAMB
    for BERT (jitted: eager JAX re-traces BERT's layer scan every call)."""
    if model == "gpt":
        cfg = jgpt.GPTConfig(**SMALL, dtype=act_dtype, attention_impl="pallas")
        params = jgpt.init(jax.random.PRNGKey(0), cfg)
        m = jamp.initialize(lambda p, t: jgpt.forward(p, t, cfg), params,
                            JFusedAdam(lr=LR, impl="pallas"), "O5",
                            arena_native=True)
        tok, tgt = (jnp.asarray(a) for a in _gpt_batch())

        def loss_fn(p):
            return jax_gpt_xent_loss(m.apply(p, tok), tgt)
    else:
        cfg = jbert.BertConfig(**SMALL, dtype=act_dtype, attention_impl="jnp")
        params = jbert.init(jax.random.PRNGKey(0), cfg)
        m = jamp.initialize(lambda p, t: jbert.forward(p, t, cfg), params,
                            JFusedLAMB(lr=LR, weight_decay=0.01, impl="pallas"),
                            "O5", arena_native=True)
        tok, tgt, mask, nsp, lens = (jnp.asarray(a) for a in _bert_batch())

        def loss_fn(p):
            mlm, nsp_logits = jbert.forward(p.unpack(), tok, cfg, seq_lens=lens)
            return jax_bert_xent_loss(mlm, nsp_logits, tgt, mask, nsp,
                                      jbert.mask_token_id(cfg))
    svag = jamp.scaled_value_and_grad(loss_fn, m.scaler, impl="pallas")

    def step(p, o, s):
        loss, g, fi, s = svag(p, s)
        p, o = m.optimizer.step(p, g, o, found_inf=fi)
        return p, o, s, loss, g, fi

    if model == "bert":
        step = jax.jit(step)
    p, o, s = m.params, m.optimizer.init(m.params), m.scaler.init()
    out = []
    for _ in range(STEPS):
        p, o, s, loss, g, fi = step(p, o, s)
        out.append(jax.tree.map(np.asarray, dict(
            loss=loss, grads=g.arenas, found_inf=fi, opt=o)))
    return jax.tree.map(np.asarray, params), out


def _port_run(model, np_params, act_dtype):
    if model == "gpt":
        cfg = tgpt.GPTConfig(**SMALL, dtype=act_dtype)
        m = tamp.initialize(lambda p, t: tgpt.forward(p, t, cfg),
                            tgpt.params_from_numpy(np_params, device="cpu"),
                            TFusedAdam(lr=LR), "O5", arena_native=True)
        tok, tgt = (torch.from_numpy(a).long() for a in _gpt_batch())

        def loss_fn(p):
            return port_gpt_xent_loss(m.apply(p, tok), tgt)
    else:
        cfg = tbert.BertConfig(**SMALL, dtype=act_dtype)
        m = tamp.initialize(lambda p, t: tbert.forward(p, t, cfg),
                            tbert.params_from_numpy(np_params, device="cpu"),
                            TFusedLAMB(lr=LR, weight_decay=0.01), "O5",
                            arena_native=True)
        tok, tgt, mask, nsp, lens = _bert_batch()
        tok, tgt, nsp = (torch.from_numpy(a).long() for a in (tok, tgt, nsp))
        mask, lens = torch.from_numpy(mask), torch.from_numpy(lens)

        def loss_fn(p):
            mlm, nsp_logits = tbert.forward(p.unpack(), tok, cfg, seq_lens=lens)
            return port_bert_xent_loss(mlm, nsp_logits, tgt, mask, nsp,
                                       tbert.mask_token_id(cfg))
    svag = tamp.scaled_value_and_grad(loss_fn, m.scaler)
    o, s = m.optimizer.init(m.params), m.scaler.init(device="cpu")
    out = []
    for _ in range(STEPS):
        loss, g, fi, s = svag(m.params, s)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        out.append(dict(loss=loss.item(), grads=[a.clone() for a in g.arenas],
                        found_inf=bool(fi),
                        masters=[a.clone() for a in o["master"]],
                        model=[a.clone() for a in m.params.arenas],
                        steps=[int(b["step"]) for b in o["inner"]]))
    return m, out


@pytest.fixture(scope="module", params=[
    ("gpt", "fp32_act"), ("gpt", "bf16_act"),
    ("bert", "fp32_act"), ("bert", "bf16_act")], ids=lambda p: "-".join(p))
def runs(request):
    model, act = request.param
    jdt, tdt = ((jnp.float32, torch.float32) if act == "fp32_act"
                else (jnp.bfloat16, torch.bfloat16))
    np_params, jout = _jax_run(model, jdt)
    m, tout = _port_run(model, np_params, tdt)
    return model, act, jout, m, tout


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("step", range(STEPS))
def test_xent_step_matches_jax(runs, step):
    """Loss, found_inf, gradient arenas, masters and step counts after each
    of three steps; the model arena is the masters' cast, bit for bit."""
    model, act, jout, m, tout = runs
    tol = TOL[model][act]
    g_atol = tol["grad_atol"][min(step, 1)]
    j, t = jout[step], tout[step]
    np.testing.assert_allclose(t["loss"], float(j["loss"]), rtol=tol["loss"])
    assert t["found_inf"] is bool(j["found_inf"]) is False
    lay = m.params.layout
    paths = tree_paths(m.params.unpack())
    for b in range(2):
        got, ref = _np(t["grads"][b]), np.asarray(j["grads"][b], np.float32)
        for i, off, shape in zip(lay.indices[b], lay.specs[b].offsets,
                                 lay.specs[b].shapes):
            sl = slice(off, off + int(np.prod(shape)))
            leaf_tol = (dict(rtol=TYPE_EMBED_TOL,
                             atol=TYPE_EMBED_TOL * float(np.abs(ref[sl]).max()))
                        if paths[i] == ("type_embed",)
                        else dict(rtol=BF16_ULP, atol=g_atol))
            np.testing.assert_allclose(got[sl], ref[sl], err_msg=str(paths[i]),
                                       **leaf_tol)
        np.testing.assert_allclose(_np(t["masters"][b]),
                                   np.asarray(j["opt"]["master"][b], np.float32),
                                   atol=tol["master"] * (step + 1), rtol=0)
        assert t["steps"][b] == int(j["opt"]["inner"][b]["step"]) == step + 1
        assert torch.equal(t["model"][b], t["masters"][b].to(t["model"][b].dtype))


def test_xent_step_loss_falls(runs):
    losses = [t["loss"] for t in runs[-1]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_bert_xent_at_smoothing_zero_is_pretrain_loss():
    """At smoothing 0 the BERT-xent objective is ``pretrain_loss``'s: the
    same loss and the same gradient of every weight, fp32."""
    cfg = tbert.BertConfig(**SMALL)
    params = tbert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok, tgt, mask, nsp, lens = _bert_batch(seed=2)
    tok, tgt, nsp = (torch.from_numpy(a).long() for a in (tok, tgt, nsp))
    mask, lens = torch.from_numpy(mask), torch.from_numpy(lens)

    def grads(loss_fn):
        p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
                 if k == "blocks" else v.clone().requires_grad_(True))
             for k, v in params.items()}
        loss = loss_fn(p)
        loss.backward()
        flat = [v for k, v in sorted(p.items()) if k != "blocks"]
        flat += [v for _, v in sorted(p["blocks"].items())]
        return loss.item(), [v.grad for v in flat]

    ref, rg = grads(lambda p: tbert.pretrain_loss(p, tok, tgt, mask, nsp, cfg,
                                                  seq_lens=lens))
    got, gg = grads(lambda p: port_bert_xent_loss(
        *tbert.forward(p, tok, cfg, seq_lens=lens), tgt, mask, nsp,
        tbert.mask_token_id(cfg)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    for a, b in zip(gg, rg):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
