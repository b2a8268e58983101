"""Flash attention on kernels K2 (forward) and K4 (backward), CUDA C++
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), and the dropout keep mask on
kernel K13 (``csrc/dropout_mask.cu``).

K2 replaces ``beforeholiday_tpu/ops/attention.py:152`` ``_fa_fwd_kernel``
(mask predicate ``:119``, dropout ``_keep_mask`` ``:130``, launched at
``:244``); K4 replaces ``_fa_dq_kernel`` (``:305``) and ``_fa_dkv_kernel``
(``:342``) with their recompute ``_block_p_ds`` (``:265``), launched by
``_fa_bwd_pallas`` (``:389``); K13 replaces ``testing/tpu_checks.py:84``
``mask_kernel``. Each source's header states its bound on an H100 and what
the design does about it. Unlike the TPU kernels, which need both sequence
lengths to tile by 128, K2 and K4 take every shape, decode's ``Sq=1``
included, and every head dim 8..512 that :func:`is_flash_available` admits,
in fp32, bf16 or fp16 (amp O1/O2); K2's decode path (``Sq < 16``) and its
paged mode take fp32 and bf16 and refuse fp16 by name.
K2's decode path (``Sq < 16``) also has a paged mode,
:func:`_paged_decode_kernel`, private to the serving engine: one query row
a sequence read against one layer's fp32 page pools in place through the
page table, bit for bit what the contiguous mode computes on the gathered,
narrowed copy (:func:`_paged_decode_torch`).

Dropout draws its keep mask from a counter-based hash: Philox4x32-10
(``csrc/philox.cuh``) keyed on a dropout key (two 32-bit words) and counted
on the absolute coordinate ``(bh, row, col)``, one hash call per 2x2 tile
of (row, col), one 32-bit word per element; an element is kept when its
top 24 bits fall below ``round((1 - rate) * 2**24)``, compared as
integers. K2, K4 and K13 include the same header, and
:func:`philox4x32` repeats it in torch integer ops, so the kernels, their
plain versions and :func:`dropout_keep_mask` draw the same mask bit for bit,
whatever tiles each one walks.

The wrappers keep the JAX module's layout at the public functions:
:func:`flash_attention` takes ``(B, H, S, D)`` and per-sequence ``kv_lens``,
:func:`flash_attention_with_lse` takes the ``(BH, S, D)`` view and also
returns ``lse`` as ``(BH, S)``. Both are differentiable: the forward saves
``(q, k, v, lens, o, lse)`` and the backward runs K4, with the ``dlse`` term
of ``_flash3_lse_bwd`` (``:503``) when the caller differentiates through
``lse``; without it K4 reads no dlse operand.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from beforeholiday_tpu_torch import _build
from beforeholiday_tpu_torch.ops._autocast import autocast_dtype
from beforeholiday_tpu_torch.ops._dispatch import resolve_impl, sm_count
from beforeholiday_tpu_torch.ops.dense import fused_dense

_NEG = -1e30  # mask fill; large-negative (not -inf) keeps exp/max NaN-free
_MIN_BLOCK = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# K2's decode path (Sq < 16) and its paged mode take fp32 and bf16 only
_DECODE_DTYPES = (torch.float32, torch.bfloat16)
# every head dim the gate admits: the tensor-core kernels take 16..128 in
# steps of 16, the CUDA-core row kernels the rest
_KERNEL_HEAD_DIMS = range(8, 513)
_MAX_GRID_Y = 65535
# the head dims K2's decode path (``csrc/flash_fwd.cu``
# flash_decode_chunk_kernel) and so its paged mode are built for; the rest
# decode on the row kernel
DECODE_HEAD_DIMS = range(16, 129, 16)
_CUDA_ERROR_INVALID_VALUE = 1  # what K2's C entry returns for a dtype it refuses

# Philox4x32-10's multipliers and key increments (Random123)
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _block_size(seq_len: int, head_dim: int = 64) -> int:
    """The TPU kernel's block (query rows == key cols) for ``seq_len``; kept
    with the JAX semantics for API parity. K2 tiles by its own constants."""
    ladder = (1024, 512, 256) if head_dim <= 128 else (512, 256)
    for cand in ladder:
        if seq_len % cand == 0:
            return cand
    return _MIN_BLOCK


def is_flash_available(seq_len: int, head_dim: int) -> bool:
    """The TPU kernel's shape gate, with the JAX semantics (API parity). K2
    and K4 themselves take any length and every head dim 8..512."""
    return seq_len % _MIN_BLOCK == 0 and 8 <= head_dim <= 512


# ------------------------------------------------------------------ dropout


def _mulhilo(a, m: int):
    """``(hi, lo)``, the 32-bit halves of ``a * m`` for ``a`` in [0, 2**32)
    (an int64 tensor or an int) and a 32-bit constant ``m``. The product
    overflows int64, so ``a`` multiplies m's 16-bit halves (each partial
    product stays below 2**48)."""
    t = a * (m & 0xFFFF)
    u = a * (m >> 16)
    t = t + ((u & 0xFFFF) << 16)
    return (u >> 16) + (t >> 32), t & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Random123's ``philox4x32``) of the counter ``(c0, c1,
    c2, c3)`` under the key ``(k0, k1)``: four 32-bit words as int64. Each
    argument is an int64 tensor of values in [0, 2**32) or an int; tensors
    broadcast. The twin of ``csrc/philox.cuh``, bit for bit, on any device."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """An element is kept when the top 24 bits of its hash word are below
    this: ``round((1 - rate) * 2**24)``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return round((1.0 - rate) * (1 << 24))


def _check_key(key, device=None):
    if not (isinstance(key, torch.Tensor) and key.dtype == torch.int64
            and key.shape == (2,)):
        raise ValueError(
            "a dropout key is an int64 tensor of shape (2,) (see "
            "transformer.tensor_parallel.random.make_key), got "
            f"{getattr(key, 'dtype', type(key))} "
            f"{tuple(getattr(key, 'shape', ()))}")
    if device is not None and key.device != device:
        raise ValueError(f"the dropout key lies on {key.device}, the data on "
                         f"{device}")


def dropout_keep_mask_torch(key: torch.Tensor, shape: Sequence[int],
                            rate: float) -> torch.Tensor:
    """Plain PyTorch version of K13: the bool keep mask of the ``(BH, rows,
    cols)`` coordinate block, on the key's device. Element ``(b, r, c)``
    reads word ``2 (r % 2) + c % 2`` of the hash of counter ``(c // 2,
    r // 2, b, 0)``."""
    BH, R, C = shape
    thr = keep_threshold(rate)
    rp, cp = (R + 1) // 2, (C + 1) // 2
    ar = functools.partial(torch.arange, dtype=torch.int64, device=key.device)
    words = philox4x32(ar(cp)[None, None, :], ar(rp)[None, :, None],
                       ar(BH)[:, None, None], 0, key[0], key[1])
    keep = [(w.expand(BH, rp, cp) >> 8) < thr for w in words]
    even = torch.stack(keep[:2], -1).reshape(BH, rp, 2 * cp)
    odd = torch.stack(keep[2:], -1).reshape(BH, rp, 2 * cp)
    mask = torch.stack((even, odd), 2).reshape(BH, 2 * rp, 2 * cp)
    return mask[:, :R, :C].contiguous()


# K13's launch: a thread owns a 2-row by 16-column patch of a (rows, cols)
# plane and walks the planes bh = blockIdx.y, + grid_y, ...
MASK_THREADS = 256
MASK_PATCH = (2, 16)


def dropout_mask_geometry(shape: Sequence[int], sms: int,
                          blocks_per_sm: int) -> dict:
    """K13's launch geometry for a ``(BH, rows, cols)`` block on a card of
    ``sms`` SMs that each hold ``blocks_per_sm`` of its blocks: the
    patches of one plane (``pairs`` x ``groups``), the grid ``(grid_x,
    grid_y)``, at most one wave of resident blocks where the planes allow,
    and the planes a thread walks (``per_thread``, at most, balanced across
    the grid). Block ``(bx, by)``'s thread ``t`` owns patch ``p = bx *
    MASK_THREADS + t`` (row pair ``p // groups``, column group ``p %
    groups``) of planes ``by, by + grid_y, ...``: every element once."""
    BH, R, C = (int(n) for n in shape)
    pr, pc = MASK_PATCH
    pairs, groups = -(-R // pr), -(-C // pc)
    patches = pairs * groups
    if patches >= 2 ** 31:
        raise ValueError(f"K13 indexes a plane's patches in int32, got "
                         f"{tuple(shape)}")
    grid_x = -(-patches // MASK_THREADS)
    wave = max(1, sms * blocks_per_sm // grid_x)
    per_thread = -(-BH // min(BH, _MAX_GRID_Y, wave))
    grid_y = -(-BH // per_thread)
    return dict(pairs=pairs, groups=groups, patches=patches, grid_x=grid_x,
                grid_y=grid_y, per_thread=per_thread)


@functools.cache
def _mask_lib():
    lib = _build.load("dropout_mask")
    fn = lib.dropout_mask
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_uint, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    lib.dropout_mask_blocks_per_sm.restype = ctypes.c_int
    return fn, max(1, lib.dropout_mask_blocks_per_sm())


def dropout_keep_mask_kernel(key: torch.Tensor, shape: Sequence[int],
                             rate: float) -> torch.Tensor:
    """Launch K13 on the key's CUDA device; returns the bool keep mask of
    the ``(BH, rows, cols)`` coordinate block."""
    if not key.is_cuda:
        raise ValueError("K13 takes a dropout key on a CUDA device")
    _check_key(key)
    BH, R, C = shape
    if max(BH, R, C) >= 2 ** 31:
        raise ValueError(f"K13 indexes each dim in int32, got {tuple(shape)}")
    thr = keep_threshold(rate)
    out = torch.empty((BH, R, C), dtype=torch.uint8, device=key.device)
    if out.numel() == 0:
        return out.view(torch.bool)
    fn, blocks_per_sm = _mask_lib()
    geo = dropout_mask_geometry(shape, sm_count(key.device.index or 0),
                                blocks_per_sm)
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        rc = fn(key.contiguous().data_ptr(), thr, out.data_ptr(), BH, R, C,
                geo["groups"], geo["patches"], geo["grid_x"], geo["grid_y"],
                stream)
    if rc != 0:
        raise RuntimeError(f"K13 (dropout_mask) launch failed with CUDA error {rc}")
    dropout_keep_mask_kernel.launches += 1
    return out.view(torch.bool)


dropout_keep_mask_kernel.launches = 0


def dropout_keep_mask(key: torch.Tensor, shape: Sequence[int], rate: float, *,
                      impl: Optional[str] = None) -> torch.Tensor:
    """The dropout keep mask (bool) of the ``(BH, rows, cols)`` coordinate
    block under ``key`` at ``rate``: the very bits K2 and K4 draw in-kernel
    for attention probabilities at ``(bh, query, key)``. K13 for a key on a
    CUDA device, the plain version for one on the CPU."""
    _check_key(key)
    impl = resolve_impl(impl, key)
    shape = tuple(int(n) for n in shape)
    if len(shape) != 3:
        raise ValueError(f"the mask's block is (BH, rows, cols), got {shape}")
    fn = dropout_keep_mask_kernel if impl == "kernel" else dropout_keep_mask_torch
    return fn(key, shape, rate)


def _drop_args(rate: float, key, device):
    """The C interface's dropout operands: key pointer, keep threshold and
    1 / (1 - rate); a null key at rate 0."""
    if rate == 0.0:
        return None, 0, 1.0
    thr = keep_threshold(rate)
    _check_key(key, device)
    if not key.is_contiguous():
        raise ValueError("the dropout key must be contiguous")
    return key.data_ptr(), thr, 1.0 / (1.0 - rate)


# ------------------------------------------------------------------ K2


def _masked(q, k, lens, causal):
    Sq, Sk = q.shape[1], k.shape[1]
    kj = torch.arange(Sk, device=q.device)
    masked = kj[None, None, :] >= lens.to(q.device)[:, None, None]
    if causal:
        masked = masked | (kj[None, :] > torch.arange(Sq, device=q.device)[:, None])
    return masked


def flash_fwd_torch(q, k, v, lens, causal: bool, scale: float,
                    rate: float = 0.0, key: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K2: ``(o, lse)`` for ``q (BH, Sq, D)``,
    ``k, v (BH, Sk, D)`` and integer ``lens (BH,)``. Computes in fp32 and
    returns ``o`` in q's dtype (the JAX oracle's contract). At ``rate > 0``
    the probabilities are dropped after the softmax with the keep mask of
    ``key`` at ``(bh, query, key)`` and the survivors scaled by
    ``1 / (1 - rate)``; ``lse`` stays the undropped one."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    masked = _masked(q, k, lens, causal)
    s = s.masked_fill(masked, _NEG)
    m = (s.amax(-1, keepdim=True) if k.shape[1]
         else s.new_full((*s.shape[:2], 1), _NEG))
    # explicit zero on masked slots: on a fully masked row s == m == _NEG
    e = torch.where(masked, 0.0, torch.exp(s - m))
    l = e.sum(-1, keepdim=True)
    nonempty = l > 0.0
    safe_l = torch.where(nonempty, l, 1.0)
    p = torch.where(nonempty, e / safe_l, 0.0)
    if rate > 0.0:
        keep = dropout_keep_mask_torch(key, p.shape, rate)
        p = torch.where(keep, p / (1.0 - rate), 0.0)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    lse = torch.where(nonempty, m + torch.log(safe_l), _NEG)[..., 0]
    return o, lse


@functools.cache
def _flash_lib():
    lib = _build.load("flash_fwd")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn = lib.flash_fwd
    fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, f, i, p, ctypes.c_uint, f,
                   p, ll, p]
    fn.restype = ctypes.c_int
    paged = lib.flash_decode_paged
    paged.argtypes = [i, p, ll, ll, p, p, p, p, p, p, p, ll, i, i, i, i, i, i,
                      f, p]
    paged.restype = ctypes.c_int
    ws = lib.flash_fwd_decode_ws_floats
    ws.argtypes = [i, i, i, i]
    ws.restype = ll
    return fn, paged, ws


def decode_workspace_floats(bh: int, sq: int, sk: int, d: int) -> int:
    """The fp32 workspace K2 needs for a call of these sizes, as the kernel
    source sizes it: a partial ``(m, l, acc[d])`` for each (bh, query row,
    chunk of keys) of its decode path; 0 for a call that takes another
    kernel or whose keys fit one chunk. Builds the kernel library."""
    return int(_flash_lib()[2](bh, sq, sk, d))


def _check_qkv(name, q, k, v, lens):
    """The q, k, v, lens checks K2 and K4 share."""
    tensors = (q, k, v, lens)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} takes q, k, v and lens on one CUDA device")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"{name} takes q (BH, Sq, D), k = v (BH, Sk, D); got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    BH, _, D = q.shape
    if k.shape[0] != BH or k.shape[2] != D or lens.shape != (BH,):
        raise ValueError(f"{name} shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, lens {tuple(lens.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name} takes one dtype of {list(_KERNEL_DTYPES)} for "
                         f"q, k, v; got {q.dtype}/{k.dtype}/{v.dtype}")
    if lens.dtype != torch.int32:
        raise ValueError(f"{name} takes int32 lens, got {lens.dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} takes head dims 8..512, got {D}")
    if BH > _MAX_GRID_Y:
        raise ValueError(f"{name} grids BH on y: {BH} > {_MAX_GRID_Y}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous q, k, v and lens")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} reads q, k, v in 16-byte vectors: align them")


def flash_fwd_kernel(q, k, v, lens, causal: bool, scale: float,
                     rate: float = 0.0, key: Optional[torch.Tensor] = None):
    """Launch K2 on CUDA tensors; returns ``(o, lse)``. Checks device, dtype,
    shape and layout and raises on anything the kernel does not take.
    ``rate > 0`` drops in-kernel with ``key``'s mask (read on the card)."""
    _check_qkv("K2", q, k, v, lens)
    kptr, thr, inv = _drop_args(rate, key, q.device)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    if BH == 0 or Sq == 0:
        return o, lse
    ws = torch.empty(decode_workspace_floats(BH, Sq, Sk, D), dtype=torch.float32,
                     device=q.device)
    fn = _flash_lib()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lens.data_ptr(), o.data_ptr(), lse.data_ptr(),
                BH, Sq, Sk, D, float(scale), int(bool(causal)), kptr, thr,
                inv, ws.data_ptr() if ws.numel() else None, ws.numel(), stream)
    if rc == _CUDA_ERROR_INVALID_VALUE and q.dtype == torch.float16:
        # the C entry takes fp16 on the training kernels only
        raise ValueError(f"K2's decode path takes {list(_DECODE_DTYPES)}, not "
                         f"torch.float16 (q {tuple(q.shape)})")
    if rc != 0:
        raise RuntimeError(f"K2 (flash_fwd) launch failed with CUDA error {rc}")
    flash_fwd_kernel.launches += 1
    return o, lse


flash_fwd_kernel.launches = 0


# ------------------------------------------------- K2's paged decode mode


def _paged_heads(q, k_pool, n_heads):
    if q.ndim != 3 or k_pool.ndim != 3 or q.shape[2] != k_pool.shape[2]:
        raise ValueError(f"paged decode takes q (B, Sq, H*D) and pools (n_pages, "
                         f"page_size, H*D); got {tuple(q.shape)}/"
                         f"{tuple(k_pool.shape)}")
    HD = q.shape[2]
    if n_heads < 1 or HD % n_heads:
        raise ValueError(f"width {HD} does not split into {n_heads} heads")
    return HD // n_heads


def _decode_gathered(fwd, q, k_pool, v_pool, page_table, kv_lens,
                     n_heads: int, scale: float):
    """Decode on a copy: each sequence's pages gathered
    (``infer.kvcache.gather_pages``), narrowed to q's dtype, and ``fwd``
    (:func:`flash_fwd_torch` or :func:`flash_fwd_kernel`) over the heads.
    Arguments and results as :func:`_paged_decode_torch`'s."""
    from beforeholiday_tpu_torch.infer.kvcache import gather_pages

    _paged_heads(q, k_pool, n_heads)
    kc = gather_pages(k_pool, page_table).to(q.dtype)
    vc = gather_pages(v_pool, page_table).to(q.dtype)
    return _decode_contiguous(fwd, q, kc, vc, kv_lens, n_heads, scale)


def _decode_contiguous(fwd, q, kc, vc, kv_lens, n_heads: int, scale: float):
    """``fwd`` (:func:`flash_fwd_torch` or :func:`flash_fwd_kernel`) over the
    heads of ``q (B, Sq, H*D)`` against contiguous ``kc``/``vc (B, Sk,
    H*D)`` of q's dtype, masked by ``kv_lens (B,)``. Returns ``o (B, Sq,
    H*D)`` and ``lse (B*H, Sq)``."""
    B, Sq, HD = q.shape
    D = HD // n_heads

    def heads(t):  # (B, S, H*D) -> (B*H, S, D)
        return t.reshape(B, t.shape[1], n_heads, D).transpose(1, 2).reshape(
            B * n_heads, t.shape[1], D).contiguous()

    lens = kv_lens.to(device=q.device, dtype=torch.int32).repeat_interleave(n_heads)
    o, lse = fwd(heads(q), heads(kc), heads(vc), lens, False, scale)
    return o.reshape(B, n_heads, Sq, D).transpose(1, 2).reshape(B, Sq, HD), lse


def _paged_decode_torch(q, k_pool, v_pool, page_table, kv_lens, n_heads: int,
                        scale: float, kv_max: Optional[int] = None):
    """Plain PyTorch version of K2's paged decode mode: :func:`_decode_gathered`
    on :func:`flash_fwd_torch`. ``q (B, Sq, H*D)``, one layer's pools
    ``(n_pages, page_size, H*D)``, ``page_table (B, n_slots)`` and ``kv_lens
    (B,)``; a sequence attends to at most ``kv_max`` keys. Returns ``o (B,
    Sq, H*D)`` in q's dtype and ``lse (B*H, Sq)``."""
    if kv_max is not None:
        kv_lens = kv_lens.clamp(max=_kv_max(kv_max))
    return _decode_gathered(flash_fwd_torch, q, k_pool, v_pool, page_table,
                            kv_lens, n_heads, scale)


def _kv_max(kv_max) -> int:
    kv_max = int(kv_max)
    if kv_max < 0:
        raise ValueError(f"kv_max must be >= 0, got {kv_max}")
    return kv_max


def _paged_decode_kernel(q, k_pool, v_pool, page_table, kv_lens, n_heads: int,
                         scale: float, kv_max: Optional[int] = None):
    """Launch K2's decode path in paged mode on CUDA tensors: one query row a
    sequence reads one layer's fp32 pools in place through ``page_table``,
    only the pages below ``kv_lens``. Same arguments and results as
    :func:`_paged_decode_torch`, which it computes exactly (the gathered,
    narrowed copy's contiguous K2, bit for bit). ``kv_max``, a bound on
    ``kv_lens`` the caller knows on the host (default: the whole table),
    sizes the grid: the kernel launches a block for each chunk of keys below
    it, not for each of the table's. q may be a strided view (the QKV
    projection's chunk) with unit column stride; the pools, table and lens
    are contiguous. Checks device, dtype, shape and layout and raises on
    anything the kernel does not take."""
    tensors = (q, k_pool, v_pool, page_table, kv_lens)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged decode takes q, the pools, the table and the "
                         "lengths on one CUDA device")
    D = _paged_heads(q, k_pool, n_heads)
    B, Sq, HD = q.shape
    if Sq != 1:
        raise ValueError(f"paged decode takes one query row a sequence, got {Sq}")
    if q.dtype not in _DECODE_DTYPES:
        raise ValueError(f"paged decode takes q in {list(_DECODE_DTYPES)}, got "
                         f"{q.dtype}")
    if q.stride(2) != 1:
        raise ValueError("paged decode reads q's columns at unit stride")
    if D not in DECODE_HEAD_DIMS:
        raise ValueError(f"paged decode takes head dims 16..128 in steps of 16, "
                         f"got {D}")
    if v_pool.shape != k_pool.shape or not (
            k_pool.dtype == v_pool.dtype == torch.float32):
        raise ValueError(f"paged decode takes two fp32 pools of one shape, got "
                         f"{k_pool.dtype} {tuple(k_pool.shape)}/{v_pool.dtype} "
                         f"{tuple(v_pool.shape)}")
    n_slots = page_table.shape[-1]
    if page_table.shape != (B, n_slots) or kv_lens.shape != (B,):
        raise ValueError(f"paged decode takes page_table (B, n_slots) and kv_lens "
                         f"(B,) for B {B}; got {tuple(page_table.shape)}/"
                         f"{tuple(kv_lens.shape)}")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise ValueError(f"paged decode takes an int32 table and lengths, got "
                         f"{page_table.dtype}/{kv_lens.dtype}")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("paged decode takes contiguous pools, table and lengths")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged decode copies pool rows in 16-byte units: align "
                         "the pools")
    page_size = k_pool.shape[1]
    sk = n_slots * page_size
    if kv_max is not None:
        sk = min(sk, _kv_max(kv_max))
    o = torch.empty((B, 1, HD), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * n_heads, 1), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, lse
    floats = decode_workspace_floats(B * n_heads, 1, sk, D)
    if floats > B * n_heads * (D + 2) * _MAX_GRID_Y:
        raise ValueError(f"paged decode grids the chunks of {sk} keys on y: at "
                         f"most {_MAX_GRID_Y}")
    ws = torch.empty(floats, dtype=torch.float32, device=q.device)
    fn = _flash_lib()[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KERNEL_DTYPES[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
                k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
                kv_lens.data_ptr(), o.data_ptr(), lse.data_ptr(),
                ws.data_ptr() if floats else None, floats, B, n_heads, D,
                n_slots, page_size, sk, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"K2 (flash_decode_paged) launch failed with CUDA "
                           f"error {rc}")
    _paged_decode_kernel.launches += 1
    return o, lse


_paged_decode_kernel.launches = 0


# ------------------------------------------------------------------ K4


def flash_bwd_torch(q, k, v, o, do, lse, dlse, lens, causal: bool,
                    scale: float, rate: float = 0.0,
                    key: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K4: ``(dq, dk, dv)`` in the inputs' dtypes,
    recomputing p from ``lse`` in fp32 as ``_block_p_ds`` does. ``dlse``
    (BH, Sq) or None. With dropout, dv takes the dropped probabilities
    ``z = keep p / (1 - rate)`` and dp becomes ``keep dp / (1 - rate)``;
    ds keeps the undropped p and delta stays ``rowsum(do o)``."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    masked = _masked(q, k, lens, causal)
    p = torch.where(masked, 0.0,
                    torch.exp(s.masked_fill(masked, _NEG) - lse[..., None]))
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    z = p
    if rate > 0.0:
        keep = dropout_keep_mask_torch(key, p.shape, rate)
        z = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    extra = dlse[..., None] if dlse is not None else 0.0
    ds = p * (dp - delta + extra) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", z, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _flash_bwd_lib():
    fn = _build.load("flash_bwd").flash_bwd
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                   f, i, p, ctypes.c_uint, f, p]
    fn.restype = ctypes.c_int
    return fn


def flash_bwd_kernel(q, k, v, o, do, lse, dlse, lens, causal: bool,
                     scale: float, rate: float = 0.0,
                     key: Optional[torch.Tensor] = None):
    """Launch K4 on CUDA tensors; returns ``(dq, dk, dv)``. Checks device,
    dtype, shape and layout and raises on anything the kernel does not
    take. ``dlse`` None reads no dlse operand; ``rate > 0`` regenerates the
    forward's keep mask from ``key``."""
    _check_qkv("K4", q, k, v, lens)
    kptr, thr, inv = _drop_args(rate, key, q.device)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"K4 takes o and do shaped and typed like q "
                         f"{tuple(q.shape)} {q.dtype}")
    rows = [lse] + ([] if dlse is None else [dlse])
    if any(t.shape != (BH, Sq) or t.dtype != torch.float32 for t in rows):
        raise ValueError(f"K4 takes fp32 lse (and dlse) of shape {(BH, Sq)}")
    tensors = (o, do, *rows)
    if not all(t.device == q.device and t.is_contiguous() for t in tensors):
        raise ValueError("K4 takes contiguous o, do, lse, dlse on q's device")
    if any(t.data_ptr() % 16 for t in (o, do)):
        raise ValueError("K4 reads o and do in 16-byte vectors: align them")
    if BH == 0 or Sq == 0 or Sk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dd = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    fn = _flash_bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                None if dlse is None else dlse.data_ptr(), lens.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dd.data_ptr(),
                BH, Sq, Sk, D, float(scale), int(bool(causal)), kptr, thr,
                inv, stream)
    if rc != 0:
        raise RuntimeError(f"K4 (flash_bwd) launch failed with CUDA error {rc}")
    flash_bwd_kernel.launches += 1
    return dq, dk, dv


flash_bwd_kernel.launches = 0


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lens, key, causal, scale, rate, impl):
        fn = flash_fwd_kernel if impl == "kernel" else flash_fwd_torch
        o, lse = fn(q, k, v, lens, causal, scale, rate, key)
        ctx.save_for_backward(q, k, v, lens, o, lse)
        ctx.causal, ctx.scale, ctx.impl = causal, scale, impl
        ctx.rate, ctx.key = rate, key  # the key is a value: K4 replays the mask
        # an unused lse gets a None cotangent, so K4 reads no dlse operand
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, lens, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        fn = flash_bwd_kernel if ctx.impl == "kernel" else flash_bwd_torch
        dq, dk, dv = fn(q, k, v, o, do.contiguous(), lse,
                        None if dlse is None else dlse.contiguous(), lens,
                        ctx.causal, ctx.scale, ctx.rate, ctx.key)
        return dq, dk, dv, None, None, None, None, None, None


def _lens_int32(kv_lens, n: int, default: int, device) -> torch.Tensor:
    if kv_lens is None:
        return torch.full((n,), default, dtype=torch.int32, device=device)
    if kv_lens.is_floating_point():
        # the JAX mask compares k >= len in float: a fractional length keeps
        # key ceil(len) - 1
        kv_lens = torch.ceil(kv_lens)
    return kv_lens.to(device=device, dtype=torch.int32)


def flash_attention_with_lse(q3: torch.Tensor, k3: torch.Tensor,
                             v3: torch.Tensor, *, causal: bool, scale: float,
                             kv_lens: Optional[torch.Tensor] = None,
                             impl: Optional[str] = None):
    """``(BH, S, D)`` flash attention returning ``(o, lse (BH, S))``. Fully
    masked rows carry ``lse = -1e30`` and ``o = 0``. Differentiable in q, k,
    v and through ``lse`` (K4 adds the dlse term)."""
    impl = resolve_impl(impl, q3)
    lens = _lens_int32(kv_lens, q3.shape[0], k3.shape[1], q3.device)
    return _FlashForward.apply(q3.contiguous(), k3.contiguous(),
                               v3.contiguous(), lens.contiguous(), None,
                               bool(causal), float(scale), 0.0, impl)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Fused scaled-dot-product attention over ``(B, H, S, D)`` inputs.

    ``kv_lens``: optional ``(B,)`` key lengths; keys at index ``>= len`` are
    masked out. Returns ``(B, H, S, D)`` in q's dtype with fp32 accumulation.
    On CUDA tensors q, k and v must share a dtype; the plain path (CPU, or
    ``impl="torch"``) also takes mixed dtypes and computes in fp32.

    ``dropout_rate``/``dropout_key``: attention-probability dropout in
    softmax -> dropout -> ``@ v`` order, inside K2 and K4; the key is an
    int64 ``(2,)`` tensor on q's device
    (:func:`~beforeholiday_tpu_torch.transformer.tensor_parallel.random.make_key`).
    A rate with no key raises; rate 0 ignores the key.

    Inside an O1/O4 autocast scope q, k and v are cast to the scope's dtype:
    the FP16_FUNCS policy applied by hand, as in the JAX package, since
    ``half_function`` would also cast a floating ``kv_lens``, whose lengths
    fp16 holds exactly only to 2048 and bf16 to 256."""
    if q.ndim != 4:
        raise ValueError(f"expected (B, H, S, D) inputs, got {tuple(q.shape)}")
    act = autocast_dtype()
    if act is not None:
        q, k, v = q.to(act), k.to(act), v.to(act)
    B, H, S, D = q.shape
    Sk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != D:
        raise ValueError(f"q/k/v shapes mismatch, got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if causal and Sk != S:
        raise ValueError(
            f"causal attention needs matching q/k lengths, got {S} vs {Sk}"
        )
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_key is None:
        raise ValueError("dropout_rate > 0 requires a dropout_key")
    keep_threshold(rate)  # validates the rate
    key = dropout_key if rate > 0.0 else None
    if key is not None:
        _check_key(key, q.device)
    impl = resolve_impl(impl, q)
    lens = _lens_int32(kv_lens, B, Sk, q.device).repeat_interleave(H)
    o, _ = _FlashForward.apply(
        q.reshape(B * H, S, D).contiguous(), k.reshape(B * H, Sk, D).contiguous(),
        v.reshape(B * H, Sk, D).contiguous(), lens.contiguous(), key,
        bool(causal), scale, rate, impl)
    return o.reshape(B, H, S, D)


def self_attention(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: Optional[torch.Tensor],
    w_out: torch.Tensor,
    b_out: Optional[torch.Tensor],
    n_heads: int,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_key: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Self-attention block: QKV projection, flash attention, output
    projection, both projections on :func:`fused_dense` (one rounding of
    product plus bias). x: (B, S, D) -> (B, S, D) in x's dtype. Inside an
    O1/O4 autocast scope x, the weights and the biases are cast to the
    scope's dtype first, by hand as in :func:`flash_attention` (``kv_lens``
    is not)."""
    act = autocast_dtype()
    if act is not None:
        x, w_qkv, w_out = x.to(act), w_qkv.to(act), w_out.to(act)
        b_qkv = None if b_qkv is None else b_qkv.to(act)
        b_out = None if b_out is None else b_out.to(act)
    B, S, D = x.shape
    hd = D // n_heads
    if hd * n_heads != D:
        raise ValueError(f"d_model {D} not divisible by n_heads {n_heads}")

    def cast(b):
        return None if b is None else b.to(x.dtype)

    qkv = fused_dense(x, w_qkv.to(x.dtype), cast(b_qkv))
    q, k, v = (t.reshape(B, S, n_heads, hd).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    ctx = flash_attention(q, k, v, causal=causal, kv_lens=kv_lens,
                          dropout_rate=dropout_rate, dropout_key=dropout_key,
                          impl=impl)
    ctx = ctx.transpose(1, 2).reshape(B, S, D)
    return fused_dense(ctx, w_out.to(x.dtype), cast(b_out))
