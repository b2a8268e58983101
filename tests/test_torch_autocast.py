"""Port parity: the per-op cast policy of amp O1/O4 (``ops._autocast``: the
``autocast`` scope and the ``half_function``/``float_function``/
``promote_function``/``banned_function`` tags), every ``amp.functional``
entry, the tagged ops of the package (dense, LayerNorm, attention), and
``checkpoint`` recomputing inside the forward's scope, held against the JAX
package (``tests/test_amp_autocast.py``'s contracts) on the same numpy
inputs. Tolerances, and why, are in PERF.md."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import amp as jamp
from beforeholiday_tpu.amp import functional as JF
from beforeholiday_tpu.ops import fused_dense as jdense
from beforeholiday_tpu.ops import fused_layer_norm as jln
from beforeholiday_tpu_torch import amp as tamp
from beforeholiday_tpu_torch.ops._autocast import quantized_enabled
from beforeholiday_tpu_torch.amp import functional as TF
from beforeholiday_tpu_torch.ops import attention as tattn
from beforeholiday_tpu_torch.ops import fused_dense as tdense
from beforeholiday_tpu_torch.ops import fused_layer_norm as tln
from beforeholiday_tpu_torch.transformer.tensor_parallel.random import checkpoint

SCOPES = {"outside": (None, None), "O1": (jnp.float16, torch.float16),
          "O4": (jnp.bfloat16, torch.bfloat16)}
NP_DTYPES = {"float32": (jnp.float32, torch.float32),
             "float16": (jnp.float16, torch.float16),
             "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _name(dt):
    return jnp.dtype(dt).name if not isinstance(dt, torch.dtype) else str(dt)[6:]


def _pair(a, dtype):
    """One numpy array as a JAX array and a tensor of the same dtype."""
    jdt, tdt = NP_DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


class _scope:
    """Both packages' autocast at one dtype (or neither)."""

    def __init__(self, name):
        self.j, self.t = SCOPES[name]

    def __enter__(self):
        if self.j is not None:
            self._jc, self._tc = jamp.autocast(self.j), tamp.autocast(self.t)
            self._jc.__enter__()
            self._tc.__enter__()

    def __exit__(self, *exc):
        if self.j is not None:
            self._tc.__exit__(*exc)
            self._jc.__exit__(*exc)


# ------------------------------------------------------------------ the tags

TAGS = ("half", "float", "promote")


def _tagged(kind):
    return {"half": (jamp.half_function, tamp.half_function),
            "float": (jamp.float_function, tamp.float_function),
            "promote": (jamp.promote_function, tamp.promote_function)}[kind]


@pytest.mark.parametrize("scope", list(SCOPES))
@pytest.mark.parametrize("kind", TAGS)
@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("float16", "float32"),
                                    ("float16", "bfloat16"), ("bfloat16", "bfloat16")])
def test_tag_dtypes_match_jax(scope, kind, dtypes):
    """Each tag on a two-input op, inside each scope and outside: the same
    input dtypes reach the op in both packages."""
    rng = np.random.default_rng(0)
    (ja, ta), (jb, tb) = (_pair(rng.standard_normal(4), d) for d in dtypes)
    seen = {}
    jtag, ttag = _tagged(kind)

    @jtag
    def jop(a, b):
        seen["jax"] = (_name(a.dtype), _name(b.dtype))
        return a

    @ttag
    def top(a, b):
        seen["torch"] = (_name(a.dtype), _name(b.dtype))
        return a

    with _scope(scope):
        jop(ja, jb)
        top(ta, tb)
    assert seen["torch"] == seen["jax"]
    assert top.__amp_list__ == kind


def test_promote_rule_is_jnps():
    """fp16 with bf16 promotes to fp32, not to the first input's dtype; one
    dtype stays as it is."""
    seen = []
    probe = tamp.promote_function(lambda a, b: seen.append((a.dtype, b.dtype)))
    half, bf16 = torch.ones(2, dtype=torch.float16), torch.ones(2, dtype=torch.bfloat16)
    with tamp.autocast(torch.float16):
        probe(half, bf16)
        probe(half, half)
    assert seen == [(torch.float32, torch.float32), (torch.float16, torch.float16)]
    assert jnp.promote_types(jnp.float16, jnp.bfloat16) == jnp.float32


@pytest.mark.parametrize("scope", list(SCOPES))
def test_banned_raises_under_fp16_only(scope):
    p = torch.full((4,), 0.5)
    t = torch.ones(4)
    with _scope(scope):
        if scope == "O1":
            with pytest.raises(RuntimeError, match="binary_cross_entropy"):
                TF.binary_cross_entropy(p, t)
            with pytest.raises(RuntimeError, match="binary_cross_entropy"):
                JF.binary_cross_entropy(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()))
        else:
            np.testing.assert_allclose(
                float(TF.binary_cross_entropy(p, t)),
                float(JF.binary_cross_entropy(jnp.asarray(p.numpy()),
                                              jnp.asarray(t.numpy()))), rtol=1e-6)


def test_scope_nests_and_restores_on_exceptions():
    assert tamp.autocast_dtype() is None
    with tamp.autocast(torch.float16):
        assert tamp.autocast_dtype() == torch.float16
        with pytest.raises(KeyError):
            with tamp.autocast("bfloat16"):
                assert tamp.autocast_dtype() == torch.bfloat16
                raise KeyError("inside")
        assert tamp.autocast_dtype() == torch.float16
    assert tamp.autocast_dtype() is None
    with pytest.raises(ValueError):
        with tamp.autocast(torch.float64):
            pass
    assert not quantized_enabled()
    with tamp.autocast(torch.float16, quantized=True):
        assert quantized_enabled() and tamp.autocast_dtype() == torch.float16
        with tamp.autocast(torch.bfloat16):  # an enclosing routing stays on
            assert quantized_enabled()
        with pytest.raises(KeyError):
            with tamp.autocast(torch.bfloat16, quantized=True):
                raise KeyError("inside")
        assert quantized_enabled() and tamp.autocast_dtype() == torch.float16
    assert not quantized_enabled()
    assert tamp.autocast_dtype() is None


# ------------------------------------------------------ amp.functional

# name -> (numpy inputs, input dtypes, extra args): every entry of the list
_RNG = np.random.default_rng(1)
_X = _RNG.standard_normal((4, 8)).astype(np.float32)
_P = _RNG.uniform(0.1, 0.9, (4, 8)).astype(np.float32)
_T = (_RNG.uniform(size=(4, 8)) > 0.5).astype(np.float32)
_LABELS = np.array([0, 3, 7, 1])
FUNCS = {
    "softmax": ((_X,), ()), "log_softmax": ((_X,), ()), "exp": ((_X,), ()),
    "log": ((_P,), ()), "log1p": ((_P,), ()), "pow": ((_P, _X), ()),
    "logsumexp": ((_X,), (-1,)), "softplus": ((_X,), ()), "erf": ((_X,), ()),
    "cross_entropy": ((_X,), ("labels",)), "nll_loss": ((_X,), ("labels",)),
    "mse_loss": ((_X, _P), ()), "l1_loss": ((_X, _P), ()),
    "binary_cross_entropy_with_logits": ((_X, _T), ()),
    "add": ((_X, _P), ()), "sub": ((_X, _P), ()), "mul": ((_X, _P), ()),
    "div": ((_X, _P), ()), "matmul": ((_X, _P.T.copy()), ()),
}


@pytest.mark.parametrize("scope", list(SCOPES))
@pytest.mark.parametrize("name", list(FUNCS))
def test_functional_matches_jax(name, scope):
    """Each entry on fp16 inputs (the promote ops on fp16 with fp32), inside
    each scope and outside: the result dtype is JAX's, and the values agree
    to fp32 rounding where the function runs in fp32, to one rounding of the
    result's type otherwise."""
    arrays, extra = FUNCS[name]
    dtypes = ["float16"] + ["float32" if name in ("add", "sub", "mul", "div", "matmul")
                            else "float16"] * (len(arrays) - 1)
    pairs = [_pair(a, d) for a, d in zip(arrays, dtypes)]
    jargs = [p[0] for p in pairs]
    targs = [p[1] for p in pairs]
    for e in extra:
        if e == "labels":
            jargs.append(jnp.asarray(_LABELS))
            targs.append(torch.from_numpy(_LABELS))
        else:
            jargs.append(e)
            targs.append(e)
    with _scope(scope):
        jout = getattr(JF, name)(*jargs)
        tout = getattr(TF, name)(*targs)
    assert _name(tout.dtype) == _name(jout.dtype)
    if tout.dtype == torch.float32:
        tol = dict(rtol=2e-6, atol=1e-6)
    else:
        tol = dict(rtol=2 ** -10, atol=2 ** -14)  # one fp16 rounding
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32), **tol)


# ------------------------------------------------ the package's tagged ops


@pytest.mark.parametrize("scope", list(SCOPES))
def test_tagged_ops_match_jax(scope):
    """fused_dense (half) and fused_layer_norm (float) on fp32 and fp16
    inputs: the dtypes and values JAX gives (dense: fp32 sums rounded once;
    LayerNorm: fp32 statistics)."""
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((4, 8)), "float32")
    jw, tw = _pair(rng.standard_normal((8, 8)) * 0.3, "float32")
    jh, th = _pair(rng.standard_normal((4, 8)), "float16")
    js, ts = _pair(1 + 0.1 * rng.standard_normal(8), "float16")
    with _scope(scope):
        jd, td = jdense(jx, jw), tdense(tx, tw)
        jn, tn = jln(jh, js, None, impl="jnp"), tln(th, ts, None)
    for j, t in ((jd, td), (jn, tn)):
        assert _name(t.dtype) == _name(j.dtype)
        ulp = {torch.float32: 1e-6, torch.float16: 2 ** -10,
               torch.bfloat16: 2 ** -7}[t.dtype]
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   rtol=ulp, atol=1e-5)


def test_attention_casts_qkv_not_lens():
    """flash_attention under fp16 autocast casts q, k and v (the output is
    fp16) and never rounds kv_lens (2049 is not an fp16 value)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2100, 8)).astype(np.float32))
    lens = torch.tensor([2049.0])
    with tamp.autocast(torch.float16):
        out = tattn.flash_attention(q, q, q, kv_lens=lens)
    assert out.dtype == torch.float16
    ref = tattn.flash_attention(q.half(), q.half(), q.half(),
                                kv_lens=torch.tensor([2049]))
    assert torch.equal(out, ref)
    rounded = tattn.flash_attention(q.half(), q.half(), q.half(),
                                    kv_lens=torch.tensor([2048]))
    assert not torch.equal(out, rounded)


@pytest.mark.parametrize("level, low", [("O1", torch.float16), ("O4", torch.bfloat16)])
def test_o1_o4_policy_matches_jax(level, low):
    """Through amp.initialize: the dense layers run low precision, the norm
    fp32 on its uncast fp32 gamma, the output the last dense's dtype; at O2
    no scope is active. Values against JAX's at the dense layers' rounding."""
    rng = np.random.default_rng(4)
    tree = {"w1": rng.standard_normal((8, 8)).astype(np.float32) * 0.3,
            "w2": rng.standard_normal((8, 8)).astype(np.float32) * 0.3,
            "ln_scale": (1 + 0.1 * rng.standard_normal(8)).astype(np.float32),
            "ln_bias": (0.1 * rng.standard_normal(8)).astype(np.float32)}
    x = rng.standard_normal((2, 8)).astype(np.float32)
    seen = {}

    def tmodel(p, x):
        h = tdense(x, p["w1"])
        seen["dense"], seen["gamma"] = h.dtype, p["ln_scale"].dtype
        h = tln(h, p["ln_scale"], p["ln_bias"])
        seen["norm"] = h.dtype
        return tdense(h, p["w2"])

    def jmodel(p, x):
        return jdense(jln(jdense(x, p["w1"]), p["ln_scale"], p["ln_bias"],
                          impl="jnp"), p["w2"])

    tm = tamp.initialize(tmodel, {k: torch.from_numpy(v) for k, v in tree.items()},
                         opt_level=level, cast_model_outputs=None)
    jm = jamp.initialize(jmodel, jax.tree.map(jnp.asarray, tree), opt_level=level,
                         cast_model_outputs=None)
    out = tm.apply(tm.params, torch.from_numpy(x))
    jout = jm.apply(jm.params, jnp.asarray(x))
    assert seen == {"dense": low, "gamma": torch.float32, "norm": torch.float32}
    assert out.dtype == low and _name(jout.dtype) == _name(low)
    assert all(v.dtype == torch.float32 for v in tm.params.values())
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32),
                               rtol=2 ** -7 if low == torch.bfloat16 else 2 ** -10,
                               atol=1e-3)

    def o2_model(p, x):
        seen["o2_scope"] = tamp.autocast_dtype()
        return x @ p["w"]

    m = tamp.initialize(o2_model, {"w": torch.ones(4, 4)}, opt_level="O2",
                        cast_model_outputs=None)
    m.apply(m.params, torch.ones(2, 4))
    assert seen["o2_scope"] is None


# ---------------------------------------------------------------- checkpoint


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_checkpoint_recomputes_in_the_scope(dtype):
    """A checkpointed block under autocast: the recompute in the backward
    runs in the forward's dtype (outside the scope it would run in fp32 and
    the saved tensors would not match), and the grads equal the
    un-checkpointed call's bit for bit."""
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32) * 0.2)
    s0 = torch.ones(16)
    dtypes = []

    def block(x, w, s):
        h = tdense(x, w)
        dtypes.append(h.dtype)
        return tln(torch.tanh(h), s, None)

    grads = []
    for wrap in (lambda f: f, checkpoint):
        x, w, s = (t.clone().requires_grad_(True) for t in (x0, w0, s0))
        with tamp.autocast(dtype):
            y = wrap(block)(x, w, s)
        y.sum().backward()
        grads.append((x.grad, w.grad, s.grad))
    assert dtypes == [dtype, dtype, dtype]  # plain, checkpointed, recomputed
    for a, b in zip(*grads):
        assert torch.equal(a, b)
