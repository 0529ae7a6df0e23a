"""Attention ops (port of ``analytics_zoo_tpu/ops/attention.py``, the
training entry point; decode and chunk attention wait for generation,
``_flash_block_update`` for ring attention).

:func:`dot_product_attention` has two interchangeable implementations:
plain PyTorch dense attention (einsum, f32 softmax, -1e30 fill), or the
flash kernels (``impl="flash"``, or ``"auto"`` on a CUDA tensor past
the crossover; :mod:`ops.flash_attention`), which keep the softmax
statistics on chip instead of writing the (B, H, Tq, Tk) logits.
``ZOO_TPU_ATTENTION`` sets the default process-wide.
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
