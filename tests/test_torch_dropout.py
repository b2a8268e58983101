"""Port parity: dropout (slice 6). The Philox twin against Random123's
published known-answer vectors; the port's dropout keys and keep masks and
their laws; ``random.dropout``, ``flash_attention`` with dropout,
``self_attention`` and the GPT and BERT forwards with a dropout key held
against the JAX package. The JAX side draws its masks from
``jax.random.bernoulli``, so these tests patch it to return the port's
masks, site by site; the two packages then compute the same function.
Also the repair of the dense layers' double rounding (the bf16 output
within one bf16 ulp of JAX's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu.ops import attention as jattn
from beforeholiday_tpu.ops import dense as jdense
from beforeholiday_tpu.testing import bert as jbert
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu.transformer.tensor_parallel import random as jrandom
from beforeholiday_tpu_torch.ops import attention as tattn
from beforeholiday_tpu_torch.ops import dense as tdense
from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_unflatten
from beforeholiday_tpu_torch.testing import _model_utils as model_utils
from beforeholiday_tpu_torch.testing import bert as tbert
from beforeholiday_tpu_torch.testing import gpt as tgpt
from beforeholiday_tpu_torch.transformer.tensor_parallel import random as trandom

MASK32 = 0xFFFFFFFF
BF16_ULP = 2.0 ** -7
# Random123's kat_vectors for philox4x32 with 10 rounds: counter, key, output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK32,) * 4, (MASK32, MASK32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _philox_int(ctr, key):
    """Philox4x32-10 in Python integers."""
    (c0, c1, c2, c3), (k0, k1) = ctr, key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & MASK32, (k1 + 0xBB67AE85) & MASK32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & MASK32)
    return c0, c1, c2, c3


def _key(seed):
    return trandom.make_key(seed, device="cpu")


# ------------------------------------------------------------- the hash


@pytest.mark.parametrize("case", range(len(PHILOX_KAT)))
def test_philox_matches_random123_vectors(case):
    ctr, key, out = PHILOX_KAT[case]
    assert _philox_int(ctr, key) == out
    got = tattn.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                             for c in (*ctr, *key)))
    assert tuple(int(w[0]) for w in got) == out


def test_philox_twin_matches_python_integers():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 32, (256, 6), dtype=np.uint64).astype(np.int64)
    words = tattn.philox4x32(*(torch.from_numpy(vals[:, i]) for i in range(6)))
    for j in range(256):
        ref = _philox_int(tuple(int(x) for x in vals[j, :4]),
                          tuple(int(x) for x in vals[j, 4:]))
        assert tuple(int(w[j]) for w in words) == ref


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 8, 16), (1, 1, 9)])
def test_keep_mask_reads_the_hash_of_its_coordinate(shape):
    """Element (b, r, c) keeps when the top 24 bits of word 2 (r % 2) + c % 2
    of the hash of (c // 2, r // 2, b, 0) fall below round(keep 2**24)."""
    rate, seed = 0.3, 77
    mask = tattn.dropout_keep_mask(_key(seed), shape, rate)
    assert mask.shape == shape and mask.dtype == torch.bool
    thr = tattn.keep_threshold(rate)
    assert thr == round(0.7 * 2 ** 24)
    for b, r, c in np.ndindex(*shape):
        word = _philox_int((c // 2, r // 2, b, 0), (seed, 0))[2 * (r % 2) + c % 2]
        assert bool(mask[b, r, c]) == ((word >> 8) < thr)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_keep_fraction_is_binomial(rate):
    mask = tattn.dropout_keep_mask(_key(5), (4, 256, 256), rate)
    n = mask.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(float(mask.sum()) - n * (1 - rate)) < 6 * sigma


def test_keep_mask_is_a_sub_block_of_a_larger_one():
    """Counting on the absolute coordinate: a block's mask is the corner of
    any larger block's, so tiles of any size draw the same bits."""
    key = _key(9)
    big = tattn.dropout_keep_mask(key, (3, 40, 50), 0.2)
    assert torch.equal(tattn.dropout_keep_mask(key, (2, 17, 33), 0.2),
                       big[:2, :17, :33])


def test_rate_zero_keeps_everything_and_bad_rates_raise():
    assert bool(tattn.dropout_keep_mask(_key(1), (2, 9, 9), 0.0).all())
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError):
            tattn.keep_threshold(rate)
    with pytest.raises(ValueError):  # a key is an int64 (2,) tensor
        tattn.dropout_keep_mask(torch.zeros(3, dtype=torch.int64), (1, 2, 2), 0.1)


@pytest.mark.parametrize("shape", [(3, 7, 13), (2, 1, 1), (70000, 3, 5), (5, 33, 70),
                                   (16, 1024, 1024), (256, 1024, 1024),
                                   (2048, 128, 128), (1, 16384, 1024), (66000, 4, 32)])
@pytest.mark.parametrize("sm_count, blocks_per_sm", [(132, 5), (132, 8), (7, 1)])
def test_k13_patches_tile_each_element_once(shape, sm_count, blocks_per_sm):
    """K13's launch geometry, walked as the kernel walks it: thread ``p``
    of block ``bx`` owns patch ``bx * MASK_THREADS + p`` of a plane (2 rows
    by 16 columns, clipped at the edges) and block row ``by`` the planes
    ``by, by + grid_y, ...``. Every element of the block is written once,
    and the grid stays inside CUDA's limits."""
    BH, R, C = shape
    geo = tattn.dropout_mask_geometry(shape, sm_count, blocks_per_sm)
    pr, pc = tattn.MASK_PATCH
    assert 1 <= geo["grid_y"] <= 65535 and geo["grid_x"] < 2 ** 31
    if geo["grid_x"] <= sm_count * blocks_per_sm and BH <= 65535:
        # one wave of resident blocks: no block waits for another to finish
        assert geo["grid_x"] * geo["grid_y"] <= sm_count * blocks_per_sm
    p = np.arange(geo["grid_x"] * tattn.MASK_THREADS)
    p = p[p < geo["patches"]]
    pair, g = p // geo["groups"], p % geo["groups"]
    plane = np.zeros((pr * geo["pairs"], pc * geo["groups"]), np.int64)
    for dr in range(pr):
        for dc in range(pc):
            np.add.at(plane, (pr * pair + dr, pc * g + dc), 1)
    assert (plane == 1).all()  # the clipped parts lie outside (R, C)
    assert plane.shape[0] - R < pr and plane.shape[1] - C < pc
    visits = np.zeros(BH, np.int64)
    walks = [np.arange(by, BH, geo["grid_y"]) for by in range(geo["grid_y"])]
    for planes in walks:
        visits[planes] += 1
    assert (visits == 1).all()
    assert max(len(w) for w in walks) == geo["per_thread"]


# ------------------------------------------------------------- the keys


def test_keys_derive_deterministically():
    key = _key(123)
    assert torch.equal(trandom.make_key(123, device="cpu"), key)
    assert key.dtype == torch.int64 and key.shape == (2,)
    f1 = trandom.fold_in(key, 7)
    assert torch.equal(f1, trandom.fold_in(key, 7))
    assert torch.equal(f1, trandom.fold_in(key, torch.tensor(7, dtype=torch.int32)))
    assert not torch.equal(f1, trandom.fold_in(key, 8))
    assert not torch.equal(f1, trandom.fold_in(_key(124), 7))
    ks = trandom.split(key, 4)
    assert ks.shape == (4, 2) and len({tuple(k.tolist()) for k in ks}) == 4
    assert torch.equal(ks, trandom.split(key, 4))
    emb, sites = model_utils.dropout_keys(key, 4)
    assert torch.equal(emb, trandom.fold_in(key, 0x7FFFFFFF))
    assert sites.shape == (4, 3, 2)
    for i in range(4):
        for s in range(3):
            assert torch.equal(sites[i, s], trandom.fold_in(ks[i], s))
    g = torch.Generator().manual_seed(0)
    drawn = trandom.make_key(generator=g, device="cpu")
    assert drawn.shape == (2,) and int(drawn.min()) >= 0 and int(drawn.max()) <= MASK32
    with pytest.raises(ValueError):
        trandom.make_key(1, generator=g, device="cpu")


def test_unported_parallel_keys_raise():
    x = torch.ones(4, 4)
    with pytest.raises(NotImplementedError):
        trandom.dropout(_key(0), x, 0.1, tp_distinct=True)
    with pytest.raises(NotImplementedError):
        trandom.model_parallel_seed(_key(0))
    with pytest.raises(NotImplementedError):
        trandom.data_parallel_seed(_key(0))


# ----------------------------------------------------- dropout against JAX


class _Bernoulli:
    """A stand-in for ``jax.random.bernoulli`` that returns the port's
    masks: for each shape, the masks in call order (the last one repeats)."""

    def __init__(self, masks_by_shape):
        self.masks = {tuple(s): list(m) for s, m in masks_by_shape.items()}
        self.calls = []

    def __call__(self, key, p, shape):
        shape = tuple(shape)
        queue = self.masks[shape]
        self.calls.append(shape)
        mask = queue.pop(0) if len(queue) > 1 else queue[0]
        return jnp.asarray(mask.numpy().reshape(shape))



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_jax(monkeypatch, dtype, rate):
    """Forward and VJP: the survivors divided by the rate's complement in
    x's dtype, bitwise."""
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 16)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    key = _key(11)
    mask = tattn.dropout_keep_mask(key, (6, 8, 16), rate)
    monkeypatch.setattr(jax.random, "bernoulli",
                        _Bernoulli({x.shape: [mask.reshape(x.shape)]}))
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    ref, vjp = jax.vjp(lambda a: jrandom.dropout(jax.random.PRNGKey(0), a, rate), jx)
    (jg,) = vjp(jw)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = trandom.dropout(key, tx, rate)
    (tg,) = torch.autograd.grad(got, tx, torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(tg.float().numpy(), np.asarray(jg, np.float32))


def test_dropout_is_identity_at_rate_zero_or_deterministic():
    x = torch.randn(4, 8)
    assert trandom.dropout(_key(0), x, 0.0) is x
    assert trandom.dropout(_key(0), x, 0.3, deterministic=True) is x
    assert trandom.dropout(None, x, 0.0) is x
    with pytest.raises(ValueError):
        trandom.dropout(None, x, 0.1)
    with pytest.raises(ValueError):
        trandom.dropout(_key(0), x, 1.0)


# (B, H, S, D, causal, kv_lens)
FLASH_CASES = {
    "causal": (1, 2, 40, 16, True, None),
    "ragged": (2, 2, 33, 8, False, [33, 12]),
}
# fp32: sums in another order; bf16: q, k, v are the same bf16 values, both
# compute in fp32 and round o once (one ulp where they straddle a boundary)
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=0),
             "bfloat16": dict(atol=2 ** -8, rtol=BF16_ULP)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_dropout_matches_jax(monkeypatch, case, dtype):
    """The port's flash attention with dropout (K2/K4's plain versions)
    against JAX's (its jnp path on the CPU), forward and VJP, on the same
    mask."""
    B, H, S, D, causal, lens = FLASH_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                   for _ in range(4))
    rate, key = 0.25, _key(21)
    mask = tattn.dropout_keep_mask(key, (B * H, S, S), rate)
    monkeypatch.setattr(jax.random, "bernoulli",
                        _Bernoulli({(B * H, S, S): [mask]}))
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def jf(a, b, c):
        return jattn.flash_attention(a, b, c, causal=causal, kv_lens=jl,
                                     dropout_rate=rate,
                                     dropout_key=jax.random.PRNGKey(1))

    ref, vjp = jax.vjp(jf, *(jnp.asarray(t, dtype) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, dtype))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(t).to(tdt).requires_grad_(True) for t in (q, k, v))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = tattn.flash_attention(tq, tk, tv, causal=causal, kv_lens=tl,
                                dropout_rate=rate, dropout_key=key)
    tgrads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)
    for a, b in zip(tgrads, jgrads):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b,
                                   **(tol if dtype == "float32" else dict(
                                       atol=2 ** -8 * np.abs(b).max(),
                                       rtol=BF16_ULP)))


def test_flash_dropout_laws():
    """Rate 0 (with or without a key) is the no-dropout path bitwise; the
    same key repeats and another differs; a rate with no key raises; with
    v = 1 the mean stays 1 and the variance follows (rate/keep) sum p^2;
    keys past kv_lens do not leak."""
    rng = np.random.default_rng(4)
    B, H, S, D = 2, 4, 64, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(np.float32))
               for _ in range(3))
    plain = tattn.flash_attention(q, k, v)
    assert torch.equal(plain, tattn.flash_attention(q, k, v, dropout_rate=0.0,
                                                    dropout_key=_key(1)))
    a = tattn.flash_attention(q, k, v, dropout_rate=0.25, dropout_key=_key(1))
    assert torch.equal(a, tattn.flash_attention(q, k, v, dropout_rate=0.25,
                                                dropout_key=_key(1)))
    assert not torch.equal(a, tattn.flash_attention(q, k, v, dropout_rate=0.25,
                                                    dropout_key=_key(2)))
    assert not torch.equal(a, plain)
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, v, dropout_rate=0.1)
    ones = tattn.flash_attention(q, k, torch.ones_like(v), dropout_rate=0.25,
                                 dropout_key=_key(3)).double()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / D ** 0.5, -1)
    pred = (0.25 / 0.75) * float((p * p).sum(-1).mean())
    assert abs(float(ones.mean()) - 1.0) < 0.02
    assert 0.7 < float(ones.var()) / pred < 1.4
    lens = torch.tensor([40, 64], dtype=torch.int32)
    v2 = v.clone()
    v2[0, :, 40:] = 99.0
    o1 = tattn.flash_attention(q, k, v, kv_lens=lens, dropout_rate=0.25,
                               dropout_key=_key(4))
    o2 = tattn.flash_attention(q, k, v2, kv_lens=lens, dropout_rate=0.25,
                               dropout_key=_key(4))
    assert torch.equal(o1[0], o2[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_attention_matches_jax(monkeypatch, dtype):
    """QKV projection, flash attention with dropout and the output
    projection, forward and VJP."""
    B, S, D, H = 2, 24, 32, 4
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) * 0.1).astype(np.float32)
    bqkv = (rng.standard_normal(3 * D) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((D, D)) * 0.1).astype(np.float32)
    bo = (rng.standard_normal(D) * 0.1).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    rate, key = 0.2, _key(31)
    mask = tattn.dropout_keep_mask(key, (B * H, S, S), rate)
    monkeypatch.setattr(jax.random, "bernoulli", _Bernoulli({(B * H, S, S): [mask]}))
    args = (x, wqkv, bqkv, wo, bo)

    def jf(*a):
        return jattn.self_attention(*a, H, causal=True, dropout_rate=rate,
                                    dropout_key=jax.random.PRNGKey(0))

    ref, vjp = jax.vjp(jf, *(jnp.asarray(t, dtype) for t in args))
    jgrads = vjp(jnp.asarray(dy, dtype))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(t).to(tdt).requires_grad_(True) for t in args]
    got = tattn.self_attention(*leaves, H, causal=True, dropout_rate=rate,
                               dropout_key=key)
    tgrads = torch.autograd.grad(got, leaves, torch.from_numpy(dy).to(tdt))
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        out_tol, grad_tol = dict(atol=2e-5, rtol=0), dict(atol=1e-4, rtol=1e-5)
    else:
        # JAX adds the bf16 biases after rounding each bf16 product, the
        # port's fused_dense rounds product plus bias once; the ~2^-8
        # differences of q, k, v and ctx pass through the softmax and the
        # projections (measured up to 0.82% of the largest value)
        out_tol = dict(atol=2 ** -6 * np.abs(ref).max(), rtol=2 ** -7)
        grad_tol = None
    np.testing.assert_allclose(got.detach().float().numpy(), ref, **out_tol)
    for a, b in zip(tgrads, jgrads):
        b = np.asarray(b, np.float32)
        tol = grad_tol or dict(atol=2 ** -6 * np.abs(b).max(), rtol=2 ** -7)
        np.testing.assert_allclose(a.float().numpy(), b, **tol)


def test_checkpoint_replays_the_same_mask():
    """A checkpointed region with dropout recomputes the same masks in the
    backward: its gradients equal the uncheckpointed ones (the JAX
    package's tests/test_dropout.py:118)."""
    key = _key(41)
    w = torch.randn(16, 16)

    def region(x):
        return trandom.dropout(key, torch.tanh(x @ w), 0.4) @ w

    x = torch.randn(8, 16, requires_grad=True)
    (g1,) = torch.autograd.grad(region(x).square().sum(), x)
    out = trandom.checkpoint(region)(x)
    (g2,) = torch.autograd.grad(out.square().sum(), x)
    assert torch.equal(g1, g2)
    assert torch.equal(trandom.checkpoint_apply(region, x), region(x))
    with pytest.raises(NotImplementedError):
        trandom.checkpoint(region, policy=lambda *a: True)


# ------------------------------------------------- the models against JAX

GPT_TINY = dict(vocab_size=64, seq_len=16, d_model=32, n_heads=2, n_layers=2,
                dropout_rate=0.1, attention_dropout=0.2)
BERT_TINY = dict(vocab_size=64, seq_len=16, d_model=32, n_heads=2, n_layers=2,
                 dropout_rate=0.1, attention_dropout=0.2)


def _same_key_for_every_layer(monkeypatch):
    """JAX's layer scan traces its body once, so every layer there reads
    the same site masks: give the port's layers one key as well."""
    monkeypatch.setattr(model_utils, "split", lambda key, n: key.expand(n, 2))


def _site_masks(key, B, S, D, H, attn_shape):
    """The port's masks of one layer's sites, and the embedding's, by the
    shape JAX's bernoulli asks for."""
    hid = (B, S, D)
    mask = lambda k, shape, rate: tattn.dropout_keep_mask(k, shape, rate)
    emb = mask(trandom.fold_in(key, 0x7FFFFFFF), hid, 0.1)
    attn = mask(trandom.fold_in(key, 0), (B * H, S, S), 0.2).reshape(attn_shape)
    s1 = mask(trandom.fold_in(key, 1), hid, 0.1)
    s2 = mask(trandom.fold_in(key, 2), hid, 0.1)
    return {hid: [emb, s1, s2, s1, s2], attn_shape: [attn]}


def _port_grads(loss_fn, params):
    leaves, treedef = tree_flatten(params)
    leaves = [p.clone().requires_grad_(True) for p in leaves]
    loss = loss_fn(tree_unflatten(treedef, leaves))
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("flash", [True, False])
def test_gpt_forward_and_grads_with_dropout_match_jax(monkeypatch, flash):
    """GPT ``loss_and_aux`` with a dropout key, fp32: loss and every
    parameter gradient, each site fed the same mask in both packages."""
    B, S, D, H = 2, GPT_TINY["seq_len"], GPT_TINY["d_model"], GPT_TINY["n_heads"]
    jcfg = jgpt.GPTConfig(**GPT_TINY, use_flash_attention=flash)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tgpt.GPTConfig(**GPT_TINY, use_flash_attention=flash)
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(6).integers(0, 64, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=-1)
    key = _key(51)
    _same_key_for_every_layer(monkeypatch)
    attn_shape = (B * H, S, S) if flash else (B, H, S, S)
    bern = _Bernoulli(_site_masks(key, B, S, D, H, attn_shape))
    monkeypatch.setattr(jax.random, "bernoulli", bern)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jgpt.loss_and_aux(p, jnp.asarray(tokens), jnp.asarray(targets),
                                    jcfg, dropout_key=jax.random.PRNGKey(9)),
        has_aux=True)(jparams)
    assert bern.calls[0] == (B, S, D) and attn_shape in bern.calls
    tok, tgt = torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()
    aux_out = {}

    def loss(p):
        value, aux_out["aux"] = tgpt.loss_and_aux(p, tok, tgt, tcfg, dropout_key=key)
        return value

    tloss, tgrads = _port_grads(loss, tparams)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert set(aux_out["aux"]) == set(jaux)
    assert all(float(v) == 0.0 for v in aux_out["aux"].values())
    for got, ref in zip(tgrads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    # no key: the JAX no-key forward, and no mask drawn
    monkeypatch.setattr(jax.random, "bernoulli", None)
    np.testing.assert_allclose(
        tgpt.forward(tparams, tok, tcfg).numpy(),
        np.asarray(jgpt.forward(jparams, jnp.asarray(tokens), jcfg)), atol=1e-4)


@pytest.mark.parametrize("flash", [True, False])
def test_bert_forward_and_grads_with_dropout_match_jax(monkeypatch, flash):
    """BERT forward with a dropout key and ragged lengths, fp32: MLM and NSP
    logits and the gradient of a weighted sum of them, each site fed the
    same mask in both packages."""
    B, S, D, H = 2, BERT_TINY["seq_len"], BERT_TINY["d_model"], BERT_TINY["n_heads"]
    jcfg = jbert.BertConfig(**BERT_TINY, use_flash_attention=flash)
    jparams = jbert.init(jax.random.PRNGKey(1), jcfg)
    tcfg = tbert.BertConfig(**BERT_TINY, use_flash_attention=flash)
    tparams = tbert.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 64, (B, S)).astype(np.int32)
    lens = np.array([S, 9], np.int32)
    wm = rng.standard_normal((B, S, 64)).astype(np.float32)
    wn = rng.standard_normal((B, 2)).astype(np.float32)
    key = _key(61)
    _same_key_for_every_layer(monkeypatch)
    attn_shape = (B * H, S, S) if flash else (B, H, S, S)
    monkeypatch.setattr(jax.random, "bernoulli",
                        _Bernoulli(_site_masks(key, B, S, D, H, attn_shape)))

    def jloss(p):
        mlm, nsp = jbert.forward(p, jnp.asarray(tokens), jcfg,
                                 seq_lens=jnp.asarray(lens),
                                 dropout_key=jax.random.PRNGKey(2))
        return jnp.sum(mlm * wm) + jnp.sum(nsp * wn), (mlm, nsp)

    (jl, (jmlm, jnsp)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    out = {}

    def tloss(p):
        mlm, nsp = tbert.forward(p, torch.from_numpy(tokens).long(), tcfg,
                                 seq_lens=torch.from_numpy(lens),
                                 dropout_key=key)
        out["mlm"], out["nsp"] = mlm, nsp
        return (mlm * torch.from_numpy(wm)).sum() + (nsp * torch.from_numpy(wn)).sum()

    tl, tgrads = _port_grads(tloss, tparams)
    np.testing.assert_allclose(out["mlm"].detach().numpy(), np.asarray(jmlm), atol=1e-4)
    np.testing.assert_allclose(out["nsp"].detach().numpy(), np.asarray(jnsp), atol=1e-4)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, ref in zip(tgrads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


# ----------------------------------------------------- the port's own laws


def _gpt(flash=True, **kw):
    cfg = tgpt.GPTConfig(**{**GPT_TINY, **kw}, use_flash_attention=flash)
    return cfg, tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_gpt_dropout_keys_and_rates():
    """No key, or a key at rates 0, is the no-dropout forward bitwise; the
    same key repeats, another key differs."""
    cfg, params = _gpt()
    tok = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(1))
    plain = tgpt.forward(params, tok, cfg)
    zero = dataclasses.replace(cfg, dropout_rate=0.0, attention_dropout=0.0)
    assert torch.equal(plain, tgpt.forward(params, tok, zero))
    assert torch.equal(plain, tgpt.forward(params, tok, zero, dropout_key=_key(1)))
    a = tgpt.forward(params, tok, cfg, dropout_key=_key(1))
    assert torch.equal(a, tgpt.forward(params, tok, cfg, dropout_key=_key(1)))
    assert not torch.equal(a, tgpt.forward(params, tok, cfg, dropout_key=_key(2)))
    assert not torch.equal(a, plain)


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_flash_matches_unfused_with_dropout(model):
    """The port's flash path (K2/K4's plain versions, the mask drawn at
    (bh, q, k)) against its unfused path (the mask of the same key on the
    (B, H, S, S) probabilities), fp32, at the JAX package's bounds
    (tests/test_gpt_flagship.py:29): loss and every gradient."""
    key = _key(71)
    if model == "gpt":
        cfg, params = _gpt()
        tok = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(2))

        def loss_of(c):
            return lambda p: tgpt.loss_and_aux(p, tok, torch.roll(tok, -1, -1), c,
                                               dropout_key=key)[0]
    else:
        cfg = tbert.BertConfig(**BERT_TINY)
        params = tbert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        tok, tgt, mask, nsp = tbert.synthetic_batch(
            cfg, 2, generator=torch.Generator().manual_seed(3), device="cpu")
        lens = torch.tensor([16, 11], dtype=torch.int32)

        def loss_of(c):
            return lambda p: tbert.pretrain_loss(p, tok, tgt, mask, nsp, c,
                                                 seq_lens=lens, dropout_key=key)
    lf, gf = _port_grads(loss_of(cfg), params)
    lu, gu = _port_grads(loss_of(dataclasses.replace(cfg, use_flash_attention=False)),
                         params)
    np.testing.assert_allclose(lu.item(), lf.item(), rtol=1e-5)
    for a, b in zip(gu, gf):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-4)


# --------------------------------------------------------- C1: one rounding


@pytest.mark.parametrize("bias_std", [0.02, 1.0])
def test_fused_dense_bf16_within_one_ulp_of_jax(bias_std):
    """The product kept in fp32, the bias added in fp32, one rounding: the
    bf16 output is within one bf16 ulp of JAX's (before the repair, 5.1% of
    the outputs at bias std 1.0 were further off). The fp32 sums run in
    another order, so an output near a rounding boundary may take the other
    side, and one where the bias cancels the product (std 0.02) may also
    differ by the sums' rounding, 2**-20 of sum |x w|."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((256, 512)).astype(np.float32)
    w = (rng.standard_normal((512, 384)) * 0.04).astype(np.float32)
    b = (rng.standard_normal(384) * bias_std).astype(np.float32)
    ref = np.asarray(jdense.fused_dense(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))),
                     np.float32)
    got = tdense.fused_dense(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)))
    got = got.float().numpy()
    bound = np.spacing(np.maximum(np.abs(ref), np.abs(got))) * 2.0 ** 16
    if bias_std < 1.0:
        bound = bound + 2.0 ** -20 * (np.abs(x) @ np.abs(w))
    assert np.all(np.abs(got - ref) <= bound)
    assert np.mean(got != ref) < 0.01
