"""Flash attention with hand-written CUDA kernels, forward, backward and
single-query decode (port of ``analytics_zoo_tpu/ops/flash_attention.py``,
without the autotuner).

Every TPU kernel of the attention family is a CUDA kernel here, in the
public (B, T, H, D) layout:

- :func:`flash_attention` without grad runs ``flash_fwd``
  (``csrc/flash_fwd.cu``, replacing ``_fwd_kernel[_masked]``, B7);
- under grad it runs :class:`_Flash`, whose forward is ``flash_block``
  (``csrc/flash_block.cu``, replacing ``_block_kernel[_masked]``, B8;
  B7 and B8 at D 64 and 128 on wgmma, :func:`fwd_route` and
  :func:`fwd_tile`) then the normalisation ``acc / max(l, 1e-30)``, and
  whose backward computes delta = rowsum(dO * O) in f32 and runs
  ``flash_bwd_dkdv`` (B9) and ``flash_bwd_dq`` (B10), FlashAttention-2's
  two kernels
  (``csrc/flash_bwd_dkdv.cu``, ``csrc/flash_bwd_dq.cu``; at D 64 and
  128 on wgmma, :func:`bwd_route` and :func:`bwd_tile`);
- :func:`flash_block_partial` is ``flash_block`` alone: the
  unnormalised f32 accumulator and the row statistics m and l, at a
  runtime q-k offset, for callers that merge partials;
- :func:`flash_decode_paged` runs ``flash_decode``
  (``csrc/flash_decode.cu``, replacing ``flash_decode_attention``,
  B11): one query row per slot against one block's paged KV cache, read
  in place through the page table (int8 pages dequantized in the
  kernel), the context split across blocks (:func:`decode_plan`), the
  decode step of generation; :func:`flash_decode_attention` runs the
  same kernel on a dense (S, T, H, D) view, one page per slot.

The two forwards share one template (``csrc/flash_fwd_sm90.cuh``) and
the two backward kernels another (``csrc/flash_bwd_sm90.cuh``), with
the pieces both use in ``csrc/flash_sm90.cuh``; at D 32 and 256 they
run ``csrc/flash_attn_fwd.cuh``'s and ``csrc/flash_attn_bwd.cuh``'s
kernels. Each header's note says what bounds its kernels on the H100. Each wrapper takes its plain PyTorch version only
for tensors on the CPU; for a CUDA tensor it launches its kernel or
raises, and counts the launch in :data:`launches`.

Semantics (the reference's): softmax in f32 whatever the input type;
masked logits are -1e30, so a row whose keys are all padding attends
uniformly, as the dense path does; causal alignment is bottom-right
(query i sees keys <= i + Tk - Tq); bf16 inputs round p and ds to bf16
before their products. One deliberate difference: a query row that
sees no key under causal masking (Tq > Tk) outputs 0 and gets no
gradient whatever the tiling, where the reference's value there
depends on its block size.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import cuda_build
from analytics_zoo_tpu_torch.ops.conv_bn import untraceable
from analytics_zoo_tpu_torch.perf import flops as _flops

_NEG_INF = -1e30
# the masked logit as an f32 holds it (the row statistics are f32), so a
# float64 plain version subtracts m exactly where a row is all padding
_MASKED = float(torch.tensor(_NEG_INF, dtype=torch.float32))

# launches of each CUDA kernel (CPU calls run the plain version and do
# not count)
launches = {"flash_fwd": 0, "flash_block": 0, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0, "flash_decode": 0}
_launch_lock = threading.Lock()

_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_D = (32, 64, 128, 256)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, kmask, o, B, H, Tq, Tk, D, 6 strides, causal, off, scale,
    # bf16, stream
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_L] * 6 + [_I] * 2 +
                 [ctypes.c_float, _I, _P],
    # q, k, v, kmask, acc, m, l, B, H, Tq, Tk, D, 6 strides, causal, off,
    # scale, bf16, stream
    "flash_block": [_P] * 7 + [_I] * 5 + [_L] * 6 + [_I] * 2 +
                   [ctypes.c_float, _I, _P],
    # q, k, v, dout, kmask, m, l, delta, dq, dk, dv, B, H, Tq, Tk, D,
    # 8 strides, causal, off, scale, bf16, stream
    "flash_bwd_dkdv": [_P] * 11 + [_I] * 5 + [_L] * 8 + [_I] * 2 +
                      [ctypes.c_float, _I, _P],
    "flash_bwd_dq": [_P] * 11 + [_I] * 5 + [_L] * 8 + [_I] * 2 +
                    [ctypes.c_float, _I, _P],
    # q, k, v, k_scales, v_scales, table, lens, kmask (bool), o,
    # work_acc, work_ml, tickets, S, H, T, D, page, pages, pages per
    # slot, chunk, chunks, q_ss, 8 strides, scale, bf16, pool type, stream
    "flash_decode": [_P] * 12 + [_I] * 9 + [_L] * 9 +
                    [ctypes.c_float, _I, _I, _P],
}
_fns = {}


def reset_launches() -> None:
    with _launch_lock:
        for k in launches:
            launches[k] = 0


def build_kernels():
    """Build the five kernels' libraries now (one ``nvcc`` each, in
    parallel); returns the seconds each took."""
    return cuda_build.build(list(_SIGNATURES))


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.load(name), name + "_launch")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name`` on the current stream of ``device``; raise
    if the launch was refused, else count it."""
    fn = _kernel_fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    with _launch_lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors, and the card's comparisons)
# ---------------------------------------------------------------------------

def _logits(q, k, key_mask, causal, scale, off, compute=torch.float32):
    """Logits (B, H, Tq, Tk) in ``compute`` (f32, or float64 for an
    exact reference) masked to -1e30, the causal visibility (Tq, Tk) or
    None, and where ds may be nonzero (or None: everywhere)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(compute), k.to(compute)) * \
        scale
    tq, tk = q.shape[1], k.shape[1]
    vis = ok = None
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None]
        cols = torch.arange(tk, device=q.device)[None, :]
        vis = rows + off >= cols
        ok = vis
    if key_mask is not None:
        keep = (key_mask > 0)[:, None, None, :]
        ok = keep if ok is None else ok & keep
    if ok is not None:
        s = s.masked_fill(~ok, _MASKED)
    return s, vis, ok


def _operand_round(x, like, compute):
    """p or ds as the products take it: rounded to a bf16 operand's
    type (the reference's rounding), else as computed."""
    return x if like.dtype == torch.float32 else x.to(like.dtype).to(compute)


def flash_block_ref(q, k, v, key_mask, causal: bool, scale: float,
                    off: int, compute=torch.float32):
    """Plain version of ``flash_block``: ``(acc (B, Tq, H, D) f32, m
    (B, H, Tq) f32, l (B, H, Tq) f32)`` with the kernel's masking rules
    and ``p`` rounded to v's type before ``p @ v`` (f32 sums). With
    ``compute=torch.float64`` every step runs in float64 on the same
    inputs and the results stay float64 (a row that sees only padding
    keeps m at the f32 -1e30): the accuracy gate's reference for the f32
    kernels."""
    s, vis, _ = _logits(q, k, key_mask, causal, scale, off, compute)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    acc = torch.einsum("bhqk,bkhd->bqhd", _operand_round(p, v, compute),
                       v.to(compute))
    return acc, m, p.sum(-1)


def _normalise(acc, l, dtype):
    return (acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(dtype)


def flash_fwd_ref(q, k, v, key_mask, causal: bool, scale: float,
                  compute=torch.float32):
    """Plain version of ``flash_fwd``: the normalised output in q's type,
    causal offset Tk - Tq (float64 with ``compute=torch.float64``, as
    :func:`flash_block_ref`)."""
    acc, _, l = flash_block_ref(q, k, v, key_mask, causal, scale,
                                k.shape[1] - q.shape[1], compute)
    return _normalise(acc, l, compute if compute == torch.float64 else
                      q.dtype)


def flash_decode_ref(q, k, v, key_mask, scale: float):
    """Plain version of ``flash_decode``: q (S, H, D) against k, v
    (S, T, H, D) under the (S, T) key mask, one query row per slot;
    returns (S, H, D) in q's type. A slot with no valid key averages all
    T keys, as the dense path does."""
    return flash_fwd_ref(q[:, None], k, v, key_mask, False, scale)[:, 0]


def decode_partials_ref(q, k, v, key_mask, scale: float, chunk: int):
    """B11's split, plainly: the unnormalised partial ``(acc (S, H, n,
    D) f32, m (S, H, n) f32, l (S, H, n) f32)`` of each chunk of
    ``chunk`` keys (n = ceil(T / chunk)) under the kernel's rules: a
    slot with a valid key reads only its valid keys, so a chunk holding
    none is empty (m = -1e30, l = 0, acc = 0); a slot with none reads
    every key at logit -1e30. p is rounded to v's type before p @ v."""
    s, h, _ = q.shape
    t = k.shape[1]
    n = -(-t // chunk)
    pad = n * chunk - t
    valid = key_mask > 0
    read = valid | ~valid.any(1, keepdim=True)       # keys the kernel reads
    lg = torch.einsum("shd,sthd->sht", q.float(), k.float()) * scale
    lg = lg.masked_fill(~valid[:, None, :], _MASKED)
    lg = F.pad(lg, (0, pad), value=_MASKED).reshape(s, h, n, chunk)
    rd = F.pad(read, (0, pad)).reshape(s, 1, n, chunk)
    m = lg.masked_fill(~rd, -math.inf).amax(-1)
    m = m.masked_fill(~rd.any(-1), _MASKED)
    p = torch.exp(lg - m[..., None]) * rd
    vc = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(s, n, chunk, h, -1)
    acc = torch.einsum("shnc,snchd->shnd", _operand_round(p, v, torch.float32),
                       vc.float())
    return acc, m, p.sum(-1)


def decode_merge(acc, m, l, dtype):
    """B11's merge of the chunk partials of :func:`decode_partials_ref`,
    in chunk order as the kernel's last block sums them: each non-empty
    chunk weighted by exp(m_c - max m), then acc / max(l, 1e-30), in
    ``dtype``."""
    live = l > 0
    mg = m.masked_fill(~live, -math.inf).amax(-1)
    mg = mg.masked_fill(torch.isinf(mg), 0.0)
    out = torch.zeros_like(acc[..., 0, :])
    lsum = torch.zeros_like(l[..., 0])
    for c in range(acc.shape[-2]):
        w = torch.where(live[..., c], torch.exp(m[..., c] - mg), 0.0)
        lsum = lsum + l[..., c] * w
        out = out + acc[..., c, :] * w[..., None]
    return (out / lsum.clamp_min(1e-30)[..., None]).to(dtype)


def _recompute(q, k, v, dout, key_mask, m, l, delta, causal, scale, off,
               compute=torch.float32):
    """p and ds ((B, H, Tq, Tk) in ``compute``) from the saved row
    statistics."""
    s, vis, ok = _logits(q, k, key_mask, causal, scale, off, compute)
    p = torch.exp(s - m.to(compute)[..., None]) / \
        l.to(compute).clamp_min(1e-30)[..., None]
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(compute), v.to(compute))
    ds = p * (dp - delta.to(compute)[..., None]) * scale
    if ok is not None:
        ds = ds.masked_fill(~ok, 0.0)
    return p, ds


def flash_bwd_dkdv_ref(q, k, v, dout, key_mask, m, l, delta,
                       causal: bool, scale: float, off: int,
                       compute=torch.float32):
    """Plain version of ``flash_bwd_dkdv``: ``(dk, dv)`` in k's and v's
    types, p and ds rounded to the operand type (f32 sums). With
    ``compute=torch.float64`` every step runs in float64 on the same
    inputs and the results stay float64: the accuracy gate's reference
    for the f32 kernels."""
    p, ds = _recompute(q, k, v, dout, key_mask, m, l, delta, causal,
                       scale, off, compute)
    dv = torch.einsum("bhqk,bqhd->bkhd", _operand_round(p, dout, compute),
                      dout.to(compute))
    dk = torch.einsum("bhqk,bqhd->bkhd", _operand_round(ds, q, compute),
                      q.to(compute))
    if compute == torch.float64:
        return dk, dv
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, dout, key_mask, m, l, delta, causal: bool,
                     scale: float, off: int, compute=torch.float32):
    """Plain version of ``flash_bwd_dq``: dq in q's type (float64 with
    ``compute=torch.float64``, as :func:`flash_bwd_dkdv_ref`)."""
    _, ds = _recompute(q, k, v, dout, key_mask, m, l, delta, causal,
                       scale, off, compute)
    dq = torch.einsum("bhqk,bkhd->bqhd", _operand_round(ds, k, compute),
                      k.to(compute))
    return dq if compute == torch.float64 else dq.to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _device_kind(name: str, t: torch.Tensor) -> str:
    untraceable(name, t)
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def _operand(name: str, t: torch.Tensor, like: torch.Tensor,
             tma: bool = False):
    """A (B, T, H, D) operand the kernels read in place: heads at stride
    D, the last axis contiguous, 16-byte aligned rows (else a
    contiguous copy); with ``tma`` (the backward's tensor maps) also
    batches that do not overlap (batch stride at least T times the time
    stride). Returns the tensor and its (batch, time) strides in
    elements."""
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (B, T, H, D), got "
                         f"{tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name}: operands on {t.device} and "
                         f"{like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name}: operand dtypes {t.dtype} and "
                        f"{like.dtype} differ")
    per16 = 16 // t.element_size()
    d = t.shape[3]
    if (t.stride(3) != 1 or t.stride(2) != d or t.stride(1) % per16 or
            t.stride(0) % per16 or t.data_ptr() % 16 or
            (tma and t.shape[0] > 1 and
             t.stride(0) < t.shape[1] * t.stride(1))):
        t = t.contiguous()
    return t, (t.stride(0), t.stride(1))


def _check_kernel(name: str, q: torch.Tensor, tq: int, tk: int) -> int:
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in {_DTYPES}")
    d = q.shape[3]
    if d not in _KERNEL_D or not _feasible(tq, tk, d):
        raise ValueError(f"{name}: need Tq, Tk multiples of 128 and head "
                         f"dim in {_KERNEL_D}; got Tq={tq} Tk={tk} D={d}")
    return d


def _kmask(key_mask, b: int, tk: int, like: torch.Tensor):
    if key_mask is None:
        return None
    if tuple(key_mask.shape) != (b, tk):
        raise ValueError(f"key_mask must be (B, Tk)=({b}, {tk}); got "
                         f"{tuple(key_mask.shape)}")
    return key_mask.to(device=like.device, dtype=torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# the products each kernel does, per B H Tq Tk D: the forward's S = QK^T
# and PV; B9's recomputed S, dV, dP and dK; B10's S, dP and dQ
_PRODUCTS = {"flash_fwd": 4, "flash_block": 4, "flash_bwd_dkdv": 8,
             "flash_bwd_dq": 6}


def _counted(name: str, q: torch.Tensor, k: torch.Tensor):
    """The kernel's products in an open FLOP count (``perf/flops.py``),
    the same on the card and on the CPU's plain version."""
    b, tq, h, d = q.shape
    return _flops.kernel(
        name, "attention", _PRODUCTS[name] * b * h * tq * k.shape[1] * d,
        f"q {tuple(q.shape)} k {tuple(k.shape)}",
        (("lhs_f", d), ("rhs_i", d), ("rhs_o", d)))


def _forward(name, q, k, v, key_mask, causal: bool, scale: float,
             off: int):
    with _counted(name, q, k):
        return _forward_launch(name, q, k, v, key_mask, causal, scale, off)


def _forward_launch(name, q, k, v, key_mask, causal: bool, scale: float,
                    off: int):
    """B7 (``flash_fwd``: the normalised output (B, Tq, H, D) in q's
    type, at offset Tk - Tq) or B8 (``flash_block``: ``(acc (B, Tq, H,
    D) f32, m (B, H, Tq) f32, l (B, H, Tq) f32)`` at causal offset
    ``off``)."""
    partial = name == "flash_block"
    if _device_kind(name, q) == "cpu":
        if partial:
            return flash_block_ref(q, k, v, key_mask, causal, scale, off)
        return flash_fwd_ref(q, k, v, key_mask, causal, scale)
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    d = _check_kernel(name, q, tq, tk)
    q, (qsb, qst) = _operand(name, q, q, tma=True)
    k, (ksb, kst) = _operand(name, k, q, tma=True)
    v, (vsb, vst) = _operand(name, v, q, tma=True)
    km = _kmask(key_mask, b, tk, q)
    km = None if km is None else _aligned(km)
    if partial:
        outs = (torch.empty((b, tq, h, d), dtype=torch.float32,
                            device=q.device),
                torch.empty((b, h, tq), dtype=torch.float32, device=q.device),
                torch.empty((b, h, tq), dtype=torch.float32, device=q.device))
    else:
        outs = (torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device),)
    _launch(name, q.device, _ptr(q), _ptr(k), _ptr(v), _ptr(km),
            *[_ptr(t) for t in outs], b, h, tq, tk, d, qsb, qst, ksb, kst,
            vsb, vst, int(causal), int(off), scale,
            int(q.dtype == torch.bfloat16))
    return outs if partial else outs[0]


def _flash_fwd(q, k, v, key_mask, causal: bool, scale: float):
    """B7: normalised output (B, Tq, H, D) in q's type."""
    return _forward("flash_fwd", q, k, v, key_mask, causal, scale,
                    k.shape[1] - q.shape[1])


def _block_partials(q, k, v, off: int, causal: bool, scale: float,
                    key_mask=None):
    """B8: ``(acc (B, Tq, H, D) f32, m (B, H, Tq) f32, l (B, H, Tq)
    f32)`` at causal offset ``off``."""
    return _forward("flash_block", q, k, v, key_mask, causal, scale, off)


def fwd_route(d: int, dtype: torch.dtype) -> str:
    """The kernel B7 and B8 run for head dim ``d`` on the card: the wgmma
    template of ``csrc/flash_fwd_sm90.cuh`` at D 64 and 128, in bf16
    (``"wgmma_bf16"``) or f32 (``"wgmma_tf32x3"``: three tf32 passes,
    f32-accurate; never plain tf32); at D 32 and 256
    ``csrc/flash_attn_fwd.cuh``'s kernels (``"mma_bf16"``: mma.sync on
    64-row tiles; ``"fma_f32"``: FMA on 16 x 16 thread tiles). The same
    routes as the backward's (:func:`bwd_route`)."""
    return bwd_route(d, dtype)


def fwd_tile(name: str, d: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(consumer warpgroups, query rows per block, keys per tile)`` of
    B7 (``flash_fwd``) or B8 (``flash_block``), one template
    (``Tile`` in ``csrc/flash_fwd_sm90.cuh``), with a producer warp
    beside the warpgroups. On the wgmma route: f32 at D 64 two
    warpgroups (128 query rows, sharing each key tile's split) on 64-key
    tiles; f32 at D 128 one warpgroup on 32-key tiles (its split tiles
    fit shared memory no other way); bf16 one warpgroup on 64-key tiles,
    so that two or three blocks share an SM (the fastest measured at
    BERT's shapes, PERF.md). Off that route ``(0, rows, keys)``: the old
    kernels' 64-row tiles (bf16) or ``f32_tile`` (f32: 64 up to D 64,
    else 32)."""
    if name not in ("flash_fwd", "flash_block"):
        raise ValueError(f"fwd_tile: no forward kernel {name!r}")
    f32 = dtype != torch.bfloat16
    if fwd_route(d, dtype).startswith("wgmma"):
        if not f32:
            return 1, 64, 64
        return (2, 128, 64) if d == 64 else (1, 64, 32)
    t = 64 if not f32 or d <= 64 else 32
    return 0, t, t


def fwd_smem(name: str, d: int, dtype: torch.dtype) -> int:
    """Shared-memory bytes a block of B7 or B8 asks for at head dim ``d``
    (the layout of ``Cfg`` in ``csrc/flash_fwd_sm90.cuh``, or the old
    kernels' ``fwd_bf16_smem``/``fwd_f32_smem``), at most
    :data:`_SMEM_LIMIT`."""
    wgs, rows, keys = fwd_tile(name, d, dtype)
    f32 = dtype != torch.bfloat16
    if not wgs:
        if not f32:
            return 3 * 64 * (d + 8) * 2 + 64 * 4
        return (3 * rows * (d + 1) + rows * (rows + 1) + 4 * rows) * 4
    esize = 4 if f32 else 2
    q = (2 if f32 else 1) * rows * d * esize     # Q (f32: hi and lo)
    ring = 2 * 2 * keys * d * esize              # two slots of K and V
    split = 3 * keys * d * 4 if f32 else 0       # K lo, V^T hi, V^T lo
    masks = 2 * keys * 4
    return q + ring + split + masks + 16 + 40 + 1024


def fwd_config_on_card(name: str, d: int, dtype: torch.dtype):
    """The tile the built library runs (its ``<name>_config``): ``(on the
    wgmma route, warpgroups, query rows per block, keys per tile, shared
    memory bytes)``, for the card tests to hold against
    :func:`fwd_route`, :func:`fwd_tile` and :func:`fwd_smem`."""
    return _config_on_card(name, d, dtype, 5)


def fwd_skip_dead(first_live: int, tk: int, q0: int, off: int,
                  causal: bool) -> bool:
    """Whether B7 and B8 skip a key tile whose keys are all padding, for
    the block whose first query row is ``q0`` (``skip_rule`` in
    ``csrc/flash_fwd_sm90.cuh``): only where that is exact, when the
    sample has a live key (``first_live``, its first, below Tk) and row
    q0 sees it (``q0 + off >= first_live`` under causal masking). Then
    every row of the block has a real logit, so m is one and each
    skipped entry would add exp(-1e30 - m) = 0. Otherwise (a sample of
    length 0; rows whose visible keys are all padding, which average
    them) the tile runs with its masks."""
    return first_live < tk and (not causal or q0 + off >= first_live)


_SMEM_LIMIT = 232448     # a block's opt-in shared memory on the H100


def bwd_route(d: int, dtype: torch.dtype) -> str:
    """The kernel B9 and B10 run for head dim ``d`` on the card: the
    wgmma template of ``csrc/flash_bwd_sm90.cuh`` at D 64 and 128, in
    bf16 (``"wgmma_bf16"``: one pass on the bf16 tensor cores) or f32
    (``"wgmma_tf32x3"``: each operand split into two tf32 parts, three
    passes, f32-accurate; never plain tf32); at D 32 and 256
    ``csrc/flash_attn_bwd.cuh``'s kernels (``"mma_bf16"``: mma.sync on
    64-row tiles; ``"fma_f32"``: FMA on 16 x 16 thread tiles)."""
    bf16 = dtype == torch.bfloat16
    if d in (64, 128):
        return "wgmma_bf16" if bf16 else "wgmma_tf32x3"
    return "mma_bf16" if bf16 else "fma_f32"


def bwd_tile(name: str, d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(warpgroups, rows per walked tile)`` of B9 (``flash_bwd_dkdv``:
    a block owns 64 keys per warpgroup and walks query tiles) or B10
    (``flash_bwd_dq``: 64 query rows per warpgroup, walking key tiles)
    on the wgmma route (``Cfg`` in ``csrc/flash_bwd_sm90.cuh``). f32 at
    D 64: two warpgroups, which share each tile's tf32 split, and 64-row
    tiles; f32 at D 128: one warpgroup and 32-row tiles (the split tiles
    fit shared memory no other way); bf16: one warpgroup and 64-row
    tiles, so that two or three blocks share an SM (faster on the H100
    than two warpgroups in one block, PERF.md). Off that route ``(0,
    rows)``: the old kernels' 64-row tiles (bf16) or ``f32_tile`` (f32:
    64 up to D 64, else 32)."""
    if name not in ("flash_bwd_dkdv", "flash_bwd_dq"):
        raise ValueError(f"bwd_tile: no backward kernel {name!r}")
    f32 = dtype != torch.bfloat16
    if bwd_route(d, dtype).startswith("wgmma"):
        if not f32:
            return 1, 64
        return (2, 64) if d == 64 else (1, 32)
    return 0, 64 if not f32 or d <= 64 else 32


def bwd_smem(name: str, d: int, dtype: torch.dtype) -> int:
    """Shared-memory bytes a block of B9 or B10 asks for at head dim
    ``d`` (the layout of ``Cfg`` in ``csrc/flash_bwd_sm90.cuh``, or the
    old kernels' ``bwd_bf16_smem``/``bwd_f32_smem``), at most
    :data:`_SMEM_LIMIT`."""
    wgs, rows = bwd_tile(name, d, dtype)
    f32 = dtype != torch.bfloat16
    if not wgs:
        if not f32:
            return 4 * 64 * (d + 8) * 2 + 4 * 64 * 4
        return (4 * rows * (d + 1) + 2 * rows * (rows + 1) + 4 * rows) * 4
    esize = 4 if f32 else 2
    dkdv = name == "flash_bwd_dkdv"
    resident = 2 * 64 * wgs * d * esize          # K and V, or Q and dO
    ring = 2 * 2 * rows * d * esize              # two slots of two tiles
    split = (6 if dkdv else 4) * rows * d * 4 if f32 else 0
    stats = 2 * (3 * rows if dkdv else rows) * 4
    return resident + ring + split + stats + 16 + 32 + 24 + 1024


def bwd_config_on_card(name: str, d: int, dtype: torch.dtype):
    """The tile the built library runs (its ``<name>_config``):
    ``(on the wgmma route, warpgroups, rows per walked tile, shared
    memory bytes)``, for the card tests to hold against
    :func:`bwd_route`, :func:`bwd_tile` and :func:`bwd_smem`."""
    return _config_on_card(name, d, dtype, 4)


def _config_on_card(name: str, d: int, dtype: torch.dtype, n: int):
    fn = getattr(cuda_build.load(name), name + "_config")
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * n)()
    rc = fn(d, int(dtype == torch.bfloat16), out)
    if rc != 0:
        raise ValueError(f"{name}: no kernel for head dim {d} (error {rc})")
    return (bool(out[0]), *out[1:])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the backward kernels copy
    rows of the statistics and the key mask in bulk)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _backward(name, q, k, v, dout, key_mask, m, l, delta, causal, scale,
              off):
    with _counted(name, q, k):
        return _backward_launch(name, q, k, v, dout, key_mask, m, l, delta,
                                causal, scale, off)


def _backward_launch(name, q, k, v, dout, key_mask, m, l, delta, causal,
                     scale, off):
    """B9 (``flash_bwd_dkdv``: returns dk, dv) or B10 (``flash_bwd_dq``:
    returns dq)."""
    if _device_kind(name, q) == "cpu":
        ref = flash_bwd_dkdv_ref if name == "flash_bwd_dkdv" else \
            flash_bwd_dq_ref
        return ref(q, k, v, dout, key_mask, m, l, delta, causal, scale, off)
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    d = _check_kernel(name, q, tq, tk)
    q, (qsb, qst) = _operand(name, q, q, tma=True)
    k, (ksb, kst) = _operand(name, k, q, tma=True)
    v, (vsb, vst) = _operand(name, v, q, tma=True)
    dout, (dsb, dst) = _operand(name, dout, q, tma=True)
    km = _kmask(key_mask, b, tk, q)
    km = None if km is None else _aligned(km)
    stats = [_aligned(t.to(device=q.device, dtype=torch.float32))
             for t in (m, l, delta)]
    dkdv = name == "flash_bwd_dkdv"
    if dkdv:
        outs = (None, torch.empty((b, tk, h, d), dtype=k.dtype,
                                  device=q.device),
                torch.empty((b, tk, h, d), dtype=v.dtype, device=q.device))
    else:
        outs = (torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device),
                None, None)
    _launch(name, q.device, _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(km),
            *[_ptr(t) for t in stats], *[_ptr(t) for t in outs],
            b, h, tq, tk, d, qsb, qst, ksb, kst, vsb, vst, dsb, dst,
            int(causal), int(off), scale, int(q.dtype == torch.bfloat16))
    return outs[1:] if dkdv else outs[0]


class _Flash(torch.autograd.Function):
    """The custom VJP of the reference's ``_flash``: B8 forward with the
    row statistics saved, B9 and B10 backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale):
        acc, m, l = _block_partials(q, k, v, k.shape[1] - q.shape[1],
                                    causal, scale, key_mask)
        out = _normalise(acc, l, q.dtype)
        ctx.save_for_backward(q, k, v, key_mask, out, m, l)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, m, l = ctx.saved_tensors
        dout = g.to(q.dtype)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        off = k.shape[1] - q.shape[1]
        args = (q, k, v, dout, key_mask, m, l, delta, ctx.causal,
                ctx.scale, off)
        dk, dv = _backward("flash_bwd_dkdv", *args)
        dq = _backward("flash_bwd_dq", *args)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _pad_heads(ts, d: int):
    """Zero-pad the head dim of CUDA operands up to the next kernel size
    (zeros change no dot product); returns them and the padded dim."""
    if ts[0].device.type != "cuda" or d in _KERNEL_D or d > 256:
        return ts, d
    dp = next(s for s in _KERNEL_D if s >= d)
    return [F.pad(t, (0, dp - d)) for t in ts], dp


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    key_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Flash attention. q, k, v: (B, T, H, D) → (B, Tq, H, D).

    Same contract as :func:`ops.attention.dot_product_attention` (f32
    softmax, bf16-safe); Tq and Tk must be multiples of 128, D at most
    256. ``key_mask``: optional (B, Tk) 0/1 key-validity (padding) mask,
    applied in the kernels (forward and backward). Runs B8 then, on the
    backward, B9 and B10 when a gradient is wanted; else B7.
    """
    d = q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
    if not _feasible(tq, tk, d):
        raise ValueError(
            f"flash_attention needs Tq/Tk divisible by 128 and D <= 256; "
            f"got Tq={tq} Tk={tk} D={d} (use dot_product_attention)")
    km = _kmask(key_mask, b, tk, q)
    (q, k, v), dp = _pad_heads([q, k, v], d)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _Flash.apply(q, k, v, km, causal, scale)
    else:
        out = _flash_fwd(q, k, v, km, causal, scale)
    return out[..., :d] if dp != d else out


def flash_block_partial(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, qk_offset, causal: bool,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """One flash pass over a K/V block, returning partials for
    cross-block merging (the ring-attention inner op).

    q, k, v: (B, Tq, H, D) / (B, Tk, H, D); ``qk_offset`` (an int, or a
    0-d tensor) = q_global_start - k_global_start (causal only).
    Returns (acc (B, Tq, H, D) f32 unnormalised, m (B, H, Tq) f32,
    l (B, H, Tq) f32) with softmax base ``m``. Not differentiable.
    """
    d = q.shape[-1]
    tq, tk = q.shape[1], k.shape[1]
    if not _feasible(tq, tk, d):
        raise ValueError(
            f"flash_block_partial needs Tq/Tk divisible by 128 and "
            f"D <= 256; got Tq={tq} Tk={tk} D={d}")
    (q, k, v), dp = _pad_heads([q, k, v], d)
    with torch.no_grad():
        acc, m, l = _block_partials(q, k, v, int(qk_offset), causal,
                                    float(scale))
    return (acc[..., :d] if dp != d else acc), m, l


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, key_mask: torch.Tensor,
                           scale: float,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-query decode attention over a dense view of the cache
    (B11, the reference's signature).

    q: (S, H, D), one new token per slot; k, v: (S, T, H, D), the dense
    page-table gather of the cache; key_mask: (S, T) 0/1 validity (1 =
    a real cached token). Returns (S, H, D) in q's type. T must be a
    multiple of 128 and D at most 256. Int8 caches pass the gathered
    views still quantized with their per-row scales ``k_scales`` /
    ``v_scales`` (S, T, H); the kernel dequantizes them as it reads
    (the plain version before it, as the reference does). The kernel is
    :func:`flash_decode_paged`'s, with one page of T rows per slot.
    Inference only: no gradient.
    """
    s, h, d = q.shape
    t = k.shape[1]
    if t % 128 or d > 256:
        raise ValueError(
            f"flash_decode_attention needs T divisible by 128 and "
            f"D <= 256; got T={t} D={d} (use decode_attention's dense "
            f"path)")
    scale = float(scale)
    if _device_kind("flash_decode", q) == "cpu":
        km = _kmask(key_mask, s, t, q)
        if k_scales is not None:
            from analytics_zoo_tpu_torch.ops.kv_cache import dequantize_rows
            k = dequantize_rows(k, k_scales, q.dtype)
            v = dequantize_rows(v, v_scales, q.dtype)
        return flash_decode_ref(q, k, v, km, scale)
    (q, k, v), dp = _pad_heads([q, k, v], d)
    k, v = [x if _decode_rows_ok(x) else x.contiguous() for x in (k, v)]
    if tuple(key_mask.shape) != (s, t):
        raise ValueError(f"key_mask must be (S, T)=({s}, {t}); got "
                         f"{tuple(key_mask.shape)}")
    # the kernel reads validity as bool: a bool mask as it lies (no
    # conversion launch), any other as ``> 0``
    km = key_mask.to(q.device)
    km = (km if km.dtype == torch.bool else km > 0).contiguous()
    out = _decode_launch(q, k, v, t, scale, kmask=km, k_scales=k_scales,
                         v_scales=v_scales)
    return out[..., :d] if dp != d else out


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       seq_lens: torch.Tensor, scale: float,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Single-query decode attention over one block's paged cache, read
    in place (B11).

    q: (S, H, D); k_pages, v_pages: (pages, page, H, D), the block's
    pools (f32, bf16, or int8 with ``k_scales``/``v_scales`` (pages,
    page, H)); page_table: (S, pages_per_slot) int32; seq_lens: (S,)
    int, key j of slot s valid iff ``j < seq_lens[s]``. The context is
    T = pages_per_slot * page, a multiple of 128; D one of 32, 64, 128,
    256 on the card. Returns (S, H, D) in q's type. Key j of slot s is
    row ``j % page`` of page ``table[s, j // page]``, clamped into the
    pool as :func:`ops.kv_cache.gather_layer` clamps; a float pool of
    another type than q is converted as it is read. On CPU tensors the
    plain version: ``gather_context`` (``gather_layer``), then
    :func:`flash_decode_attention` (``dequantize_rows`` and
    :func:`flash_decode_ref`)."""
    s, h, d = q.shape
    t = page_table.shape[1] * k_pages.shape[1]
    if t % 128 or d > 256:
        raise ValueError(
            f"flash_decode_paged needs a context divisible by 128 and "
            f"D <= 256; got T={t} D={d}")
    # the kernel reads table[s] and seq_lens[s] for every slot of q
    if page_table.dim() != 2 or page_table.shape[0] != s or \
            tuple(seq_lens.shape) != (s,):
        raise ValueError(
            f"flash_decode_paged: q has {s} slots, page_table "
            f"{tuple(page_table.shape)} and seq_lens "
            f"{tuple(seq_lens.shape)} must have one row each")
    scale = float(scale)
    if _device_kind("flash_decode", q) == "cpu":
        from analytics_zoo_tpu_torch.ops import kv_cache as kvc
        k, v, sk, sv = kvc.gather_context(k_pages, v_pages, page_table, t,
                                          q.dtype, k_scales, v_scales)
        return flash_decode_attention(q, k, v, kvc.length_mask(seq_lens, t),
                                      scale, k_scales=sk, v_scales=sv)
    for x in (k_pages, v_pages):
        if not _decode_rows_ok(x):
            raise ValueError(
                f"flash_decode_paged: a pool of shape {tuple(x.shape)} "
                f"and strides {x.stride()} is not read in place (heads "
                f"at stride D, the last axis contiguous, 16-byte aligned "
                f"rows: H * D * size a multiple of 16)")
    return _decode_launch(q, k_pages, v_pages, t, scale, table=page_table,
                          lens=seq_lens, k_scales=k_scales,
                          v_scales=v_scales)


# B11's block (csrc/flash_decode.cu): 8 warps, each key group of lanes
# keeping 2 keys in flight, four blocks per SM; the plan aims at 4 x 132
# blocks (the H100's SMs) and chunks of at least 64 keys
_DECODE_KV = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_DECODE_SIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_DECODE_WARPS, _DECODE_UNROLL = 8, 2
_DECODE_BLOCKS, _DECODE_MIN_CHUNK = 4 * 132, 64


def decode_lanes(d: int, kv_dtype: torch.dtype) -> int:
    """Lanes per key of B11's block (``Geo`` in ``csrc/flash_decode.cu``):
    enough 16-byte loads of the pool's type to cover a row of D, at most
    a warp."""
    return min(d * _DECODE_SIZE[kv_dtype] // 16, 32)


def decode_keys(d: int, kv_dtype: torch.dtype) -> int:
    """Keys a block of B11 reads per iteration (``Geo::KI``): the key
    groups of its warps, each with its keys in flight."""
    return _DECODE_WARPS * (32 // decode_lanes(d, kv_dtype)) * _DECODE_UNROLL


def decode_takes(d: int) -> bool:
    """Whether B11 has a build for head dim D and so reads a paged cache
    in place; another D up to 256 runs B11 on the gathered view, padded
    up to the next head dim it has."""
    return d in _KERNEL_D


@functools.lru_cache(maxsize=256)
def decode_plan(s: int, h: int, t: int, d: int,
                kv_dtype: torch.dtype) -> Tuple[int, int]:
    """``(chunk, chunks)``: how B11 splits a context of T keys across
    blocks, from the shapes alone (never the lengths: reading them would
    make the host wait on the card every layer). The chunk is a power of
    two, at least 64 keys and the keys a block reads per iteration,
    doubled while the grid (chunks, H, S) keeps at least 4 x 132 blocks
    (four per SM of the H100), so the longest slot's keys spread over
    many SMs."""
    chunk = max(decode_keys(d, kv_dtype), _DECODE_MIN_CHUNK)
    while 2 * chunk < t and \
            s * h * -(-t // (2 * chunk)) >= _DECODE_BLOCKS:
        chunk *= 2
    return chunk, -(-t // chunk)


def decode_config_on_card(d: int, kv_dtype: torch.dtype) -> Tuple[int, int]:
    """``(lanes per key, keys per block iteration)`` of the built library
    (``flash_decode_config``), for the card tests to hold against
    :func:`decode_lanes` and :func:`decode_keys`."""
    fn = cuda_build.load("flash_decode").flash_decode_config
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    rc = fn(d, _DECODE_KV[kv_dtype], out)
    if rc != 0:
        raise ValueError(f"flash_decode: no kernel for head dim {d}")
    return out[0], out[1]


_tickets = {}


def _decode_tickets(device: torch.device, n: int) -> torch.Tensor:
    """B11's tickets on the current stream of ``device``: zeros, which
    every launch leaves zero (its last block per (slot, head) resets
    its own), so they are allocated once per stream."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def _decode_rows_ok(x: torch.Tensor) -> bool:
    """Whether B11 reads a (pages or slots, rows, H, D) operand in place:
    heads at stride D, the last axis contiguous, 16-byte aligned rows."""
    per16 = 16 // x.element_size()
    return (x.dim() == 4 and x.stride(3) == 1 and
            x.stride(2) == x.shape[3] and x.stride(2) % per16 == 0 and
            x.stride(1) % per16 == 0 and x.stride(0) % per16 == 0 and
            x.data_ptr() % 16 == 0)


def _decode_launch(q, k, v, t: int, scale: float, table=None, lens=None,
                   kmask=None, k_scales=None, v_scales=None):
    """Launch B11: q (S, H, D) against k, v (pages, rows, H, D), read in
    place, through ``table`` (S, pages per slot) or, without one, page s
    of T rows per slot; validity from ``lens`` (S,) or ``kmask`` (S, T)
    bool, whose shapes the callers checked."""
    name = "flash_decode"
    s, h, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in {_DTYPES}")
    kv = _DECODE_KV.get(k.dtype)
    if kv is None or v.dtype != k.dtype:
        raise TypeError(f"{name}: pool dtypes {k.dtype}, {v.dtype}")
    if (kv == 2) != (k_scales is not None) or \
            (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: int8 pools need both scales, and only "
                         f"they")
    if d not in _KERNEL_D or tuple(k.shape[2:]) != (h, d) or \
            v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, pools "
                         f"{tuple(k.shape)} {tuple(v.shape)} (head dim "
                         f"in {_KERNEL_D})")
    dev = q.device
    others = [x for x in (k, v, k_scales, v_scales, table, lens, kmask)
              if x is not None]
    if any(x.device != dev for x in others):
        raise ValueError(f"{name}: operands on "
                         f"{sorted({str(x.device) for x in others})} and "
                         f"{dev}")
    q, q_ss = _query(name, q)
    scales = []
    for sc in (k_scales, v_scales):
        if sc is None:
            scales += [None, 0, 0]
            continue
        if sc.dtype != torch.float32 or tuple(sc.shape) != \
                tuple(k.shape[:3]) or sc.stride(2) != 1:
            raise ValueError(f"{name}: scales {tuple(sc.shape)} "
                             f"{sc.dtype} for pools {tuple(k.shape)}")
        scales += [sc, sc.stride(0), sc.stride(1)]
    if table is not None and (table.dtype != torch.int32 or
                              not table.is_contiguous()):
        table = table.to(torch.int32).contiguous()
    if lens is not None and (lens.dtype != torch.int32 or
                             not lens.is_contiguous()):
        lens = lens.to(torch.int32).contiguous()
    chunk, n = decode_plan(s, h, t, d, k.dtype)
    out = torch.empty((s, h, d), dtype=q.dtype, device=dev)
    # the partials: acc (S, H, chunks, D), then m and l (S, H, chunks, 2)
    work = torch.empty((s * h * n * (d + 2),), dtype=torch.float32,
                       device=dev)
    tickets = _decode_tickets(dev, s * h)
    _launch(name, dev, _ptr(q), _ptr(k), _ptr(v), _ptr(scales[0]),
            _ptr(scales[3]), _ptr(table), _ptr(lens), _ptr(kmask),
            _ptr(out), work.data_ptr(), work.data_ptr() + 4 * s * h * n * d,
            _ptr(tickets),
            s, h, t, d, k.shape[1], k.shape[0],
            1 if table is None else table.shape[1], chunk, n, q_ss,
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            scales[1], scales[2], scales[4], scales[5], scale,
            int(q.dtype == torch.bfloat16), kv)
    return out


def _query(name: str, q: torch.Tensor):
    """The (S, H, D) decode query as the kernel reads it: heads at
    stride D, the last axis contiguous (else a contiguous copy). Returns
    it and its slot stride in elements."""
    d = q.shape[2]
    if q.stride(2) != 1 or q.stride(1) != d:
        q = q.contiguous()
    return q, q.stride(0)


def as_key_mask(mask, b: int, tk: int):
    """Reduce an attention mask (broadcastable to (B, H, Tq, Tk)) to the
    kernels' (B, Tk) key-validity form, or None if it varies per query
    or head (decided from the shape). Only the explicit 4-D
    (B|1, 1, 1, Tk) form qualifies, BERT's padding mask; a 2-D mask is
    not accepted, because the dense path broadcasts 2-D as (Tq, Tk)."""
    if mask is None:
        return None
    shp = tuple(mask.shape)
    if mask.dim() == 4 and shp[1] == 1 and shp[2] == 1 and \
            shp[3] == tk and shp[0] in (1, b):
        return mask[:, 0, 0, :].expand(b, tk)
    return None


def supports(tq: int, tk: int, d: int, mask: Optional[torch.Tensor],
             b: Optional[int] = None) -> bool:
    """Whether the kernels handle this problem (else the caller takes
    the dense path): 128-divisible sequence lengths, D <= 256, and a
    mask that is absent or a pure key-padding mask (causal is native)."""
    if not _feasible(tq, tk, d):
        return False
    if mask is None:
        return True
    return b is not None and as_key_mask(mask, b, tk) is not None


def _feasible(tq: int, tk: int, d: int) -> bool:
    """The one shape rule of the kernels: Tq and Tk multiples of 128, D
    at most 256 (the reference's ``_heuristic_blocks`` divisibility
    rule; the CUDA tiles are 64 or 32 rows whatever it picked)."""
    return tq % 128 == 0 and tk % 128 == 0 and d <= 256
