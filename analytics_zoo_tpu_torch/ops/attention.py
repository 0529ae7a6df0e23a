"""Attention ops (port of ``analytics_zoo_tpu/ops/attention.py``: the
training entry point, decode and chunk attention; ``_flash_block_update``
waits for ring attention).

:func:`dot_product_attention` has two interchangeable implementations:
plain PyTorch dense attention (einsum, f32 softmax, -1e30 fill), or the
flash kernels (``impl="flash"``, or ``"auto"`` on a CUDA tensor past
the crossover; :mod:`ops.flash_attention`), which keep the softmax
statistics on chip instead of writing the (B, H, Tq, Tk) logits.
``ZOO_TPU_ATTENTION`` sets the default process-wide.
:func:`decode_attention` is its single-query sibling for generation,
routed the same way to the decode kernel (B11), and
:func:`paged_decode_attention` the same over the paged cache's pools,
which B11 reads in place. :func:`chunk_attention` attends C new
tokens per slot over the gathered cache (chunked prefill, speculative
verify); it is dense in the reference too, and here plain PyTorch.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def resolve_attention_impl(impl: Optional[str]) -> str:
    """None → ``ZOO_TPU_ATTENTION`` (default "auto"); validated against
    the known impls. The one copy of this policy, used by
    :func:`dot_product_attention` and the transformer layers."""
    impl = impl or os.environ.get("ZOO_TPU_ATTENTION", "auto")
    if impl not in ("xla", "flash", "auto"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return impl


def flash_backend_ok(t: torch.Tensor) -> bool:
    """Whether "auto" may route ``t``'s attention to the kernels: a CUDA
    tensor. Explicit ``impl="flash"`` ignores this."""
    return t.is_cuda


def flash_profitable(tk: int) -> bool:
    """Whether flash beats dense at this key length: the reference's
    rule, Tk >= 1024 (``ZOO_TPU_FLASH_MIN_T`` overrides the threshold).
    ``chip_smoke.py`` measures the H100's crossover; the constant moves
    only with that measurement."""
    env = os.environ.get("ZOO_TPU_FLASH_MIN_T")
    return tk >= (int(env) if env is not None else 1024)


def decode_flash_profitable(tk: int) -> bool:
    """Whether the decode kernel beats dense single-query attention at
    this cache length: the reference's rule, T >= 2048
    (``ZOO_TPU_DECODE_FLASH_MIN_T`` overrides the threshold).
    ``chip_smoke.py`` measures the H100's crossover; the constant moves
    only with that measurement."""
    env = os.environ.get("ZOO_TPU_DECODE_FLASH_MIN_T")
    return tk >= (int(env) if env is not None else 2048)


def decode_route(t: int, d: int, impl: str, q: torch.Tensor) -> bool:
    """Whether decode attention over a context of T keys takes the decode
    kernel (B11): T a multiple of 128, D <= 256, and ``impl="flash"`` or
    "auto" on a CUDA tensor with T past the crossover; else dense. The
    one copy of this rule, for :func:`decode_attention` and
    :func:`paged_decode_attention`."""
    return t % 128 == 0 and d <= 256 and (
        impl == "flash" or (impl == "auto" and flash_backend_ok(q)
                            and decode_flash_profitable(t)))


def _dense_decode(q, k, v, seq_lens, scale: float, k_scales=None,
                  v_scales=None):
    if k_scales is not None:
        from analytics_zoo_tpu_torch.ops.kv_cache import dequantize_rows
        k = dequantize_rows(k, k_scales, q.dtype)
        v = dequantize_rows(v, v_scales, q.dtype)
    t = k.shape[1]
    logits = torch.einsum("shd,sthd->sht", q, k).float() * scale
    valid = torch.arange(t, device=q.device)[None, None, :] < \
        seq_lens[:, None, None]
    logits = logits.masked_fill(~valid, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("sht,sthd->shd", probs, v)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     seq_lens: torch.Tensor,
                     scale: Optional[float] = None,
                     impl: Optional[str] = None,
                     k_scales: Optional[torch.Tensor] = None,
                     v_scales: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-query (decode-mode) attention against a cached context.

    q: (S, H, D), one new token per slot; k, v: (S, T, H, D), the
    gathered cache (``ops.kv_cache.gather_layer``); ``seq_lens`` (S,)
    masks positions ``>= seq_lens[s]``. Returns (S, H, D); softmax in
    f32 whatever the input type. Int8 caches pass the views still
    quantized with their per-row scales (S, T, H), dequantized here or
    by the kernel. Routing: :func:`decode_route` (the decode kernel,
    B11, or dense). No causal mask: the cache holds only positions the
    new token may see. :func:`paged_decode_attention` takes the pools
    and the page table instead of the gathered view.
    """
    impl = resolve_attention_impl(impl)
    d = q.shape[-1]
    t = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    if decode_route(t, d, impl, q):
        from analytics_zoo_tpu_torch.ops import flash_attention as fa
        key_mask = torch.arange(t, device=q.device)[None, :] < \
            seq_lens[:, None]
        return fa.flash_decode_attention(q, k, v, key_mask, scale,
                                         k_scales=k_scales,
                                         v_scales=v_scales)
    return _dense_decode(q, k, v, seq_lens, scale, k_scales, v_scales)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           seq_lens: torch.Tensor,
                           scale: Optional[float] = None,
                           impl: Optional[str] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-query attention against one block's paged cache: the one
    place that decides how the decode step reads its pools.

    q: (S, H, D); k_pages, v_pages: (pages, page, H, D) (int8 with their
    (pages, page, H) scales); page_table: (S, pages_per_slot); seq_lens:
    (S,) keys valid per slot. The context is pages_per_slot * page.
    Where :func:`decode_route` takes B11, the kernel reads the pages in
    place through the table (``flash_decode_paged``; on CPU tensors its
    plain version, which gathers); a head dim the kernel does not have
    (it pads D up to 32, 64, 128 or 256) runs B11 on the gathered view.
    Otherwise the pools are gathered to (S, T, H, D), converted to q's
    type (int8 stays quantized with its gathered scales), and attended
    densely, the reference's decode step."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.ops import kv_cache as kvc
    impl = resolve_attention_impl(impl)
    d = q.shape[-1]
    t = page_table.shape[1] * k_pages.shape[1]
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    b11 = decode_route(t, d, impl, q)
    if b11 and (not q.is_cuda or fa.decode_takes(d)):
        return fa.flash_decode_paged(q, k_pages, v_pages, page_table,
                                     seq_lens, scale, k_scales=k_scales,
                                     v_scales=v_scales)
    k, v, sk, sv = kvc.gather_context(k_pages, v_pages, page_table, t,
                                      q.dtype, k_scales, v_scales)
    if b11:
        return fa.flash_decode_attention(q, k, v,
                                         kvc.length_mask(seq_lens, t),
                                         scale, k_scales=sk, v_scales=sv)
    return _dense_decode(q, k, v, seq_lens, scale, sk, sv)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor,
                    scale: Optional[float] = None,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention for a chunk of C new tokens per slot against the cache.

    q: (S, C, H, D), the chunk's queries at absolute positions
    ``q_positions`` (S, C); k, v: (S, T, H, D), gathered cache views that
    already hold the chunk's own rows (callers write before they
    gather). The mask ``key_pos <= q_pos`` gives causality inside the
    chunk and validity against the cache in one comparison: stale rows
    past a query's position stay invisible. Logits in f32, filled with
    -1e30, so a slot with no visible key gets a uniform row, never NaN
    (callers drop such rows). Int8 views come with their (S, T, H)
    scales and are dequantized to q's type here. Returns (S, C, H, D).
    """
    d = q.shape[-1]
    t = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    if k_scales is not None:
        from analytics_zoo_tpu_torch.ops.kv_cache import dequantize_rows
        k = dequantize_rows(k, k_scales, q.dtype)
        v = dequantize_rows(v, v_scales, q.dtype)
    logits = torch.einsum("schd,sthd->shct", q, k).float() * scale
    visible = torch.arange(t, device=q.device)[None, None, :] <= \
        q_positions[:, :, None]                           # (S, C, T)
    logits = logits.masked_fill(~visible[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("shct,sthd->schd", probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          impl: Optional[str] = None) -> torch.Tensor:
    """Standard attention. q, k, v: (B, T, H, D) → (B, Tq, H, D).

    ``mask``: broadcastable to (B, H, Tq, Tk), nonzero = attend. Softmax
    in f32 whatever the input type. ``impl``: "auto" (the flash kernels
    when the problem qualifies: 128-divisible lengths, no mask or a
    pure key-padding mask like BERT's (B, 1, 1, Tk), a CUDA tensor, and
    Tk past the crossover; else dense), "flash" (the kernels or an
    error, never dense) or "xla" (dense).
    """
    impl = resolve_attention_impl(impl)
    if impl == "flash" or (impl == "auto" and flash_backend_ok(q)
                           and flash_profitable(k.shape[1])):
        from analytics_zoo_tpu_torch.ops import flash_attention as fa
        km = fa.as_key_mask(mask, q.shape[0], k.shape[1])
        if fa.supports(q.shape[1], k.shape[1], q.shape[-1], None) and (
                mask is None or km is not None):
            return fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                      key_mask=km)
        if impl == "flash":
            raise ValueError(
                f"impl='flash' unsupported for Tq={q.shape[1]} "
                f"Tk={k.shape[1]} mask={mask is not None} (need "
                f"128-divisible T and a key-padding-only mask); use "
                f"'auto' to fall back silently")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        visible = torch.ones((tq, tk), dtype=torch.bool,
                             device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~visible, -1e30)
    if mask is not None:
        logits = logits.masked_fill(mask == 0, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
