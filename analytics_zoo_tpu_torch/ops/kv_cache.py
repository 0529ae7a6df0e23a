"""Paged KV cache for autoregressive decode (port of
``analytics_zoo_tpu/ops/kv_cache.py``).

K and V live in a fixed pool of small pages per block, ``(max_pages,
page_size, heads, head_dim)``, allocated once; a per-slot page table
maps logical token positions to physical pages (vLLM's PagedAttention).
A sequence's growth writes one (heads, head_dim) row into a page it
already owns, so no tensor ever changes shape:

- :func:`init_cache` allocates the pool (zeros) and an identity table;
- :func:`append_layer` writes one new token's K/V per slot into one
  block's pool;
- :func:`write_prompt_layer` writes a whole (right-padded) prompt's
  K/V, or with ``start`` a partial chunk of it;
- :func:`gather_layer` / :func:`length_mask` give the dense (S, T, H, D)
  view and its key-validity mask for attention (the decode kernel, B11,
  reads the pages in place through the table instead:
  ``ops.attention.paged_decode_attention``);
- :func:`gather_slot_pages` / :func:`scatter_slot_pages` move one
  sequence's pages out of one pool and into another (the KV handoff
  between a prefill engine and a decode engine), and
  :func:`handoff_to_wire` / :func:`handoff_from_wire` carry the
  handoff blob through JSON.

Unlike the reference, whose arrays are immutable, the writes update the
pools **in place** (a 1.2 GB pool cannot be copied every step) and
return the same tensors; callers that need the old state clone it
first. The reference drops the rows it must not write by routing them
to an out-of-range page (``mode="drop"``); on a CUDA tensor an
out-of-range index is a device assert, so here the inactive rows are
filtered out before the scatter (:func:`_scatter_coords`) and nothing
is ever written to a sentinel.

Int8 pages: the pool stores int8 rows plus one f32 scale per (token,
head), ``max|x| / 127`` over head_dim (:func:`quantize_rows`), written
through the same coordinates as the rows; :func:`dequantize_rows`
restores the values at the gather, before attention (B11 forms the same
values as it reads the int8 rows).

:class:`PageAllocator` is the host-side free list of physical pages the
generation engine assigns at admission and reclaims at retirement.
"""

from __future__ import annotations

import base64
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class PagedKVCache(NamedTuple):
    """The cache state threaded through the decode loop.

    ``k_pages``/``v_pages``: (num_layers, max_pages, page_size, heads,
    head_dim). ``page_table``: (max_slots, pages_per_slot) int32
    physical page ids. ``seq_lens``: (max_slots,) int32 tokens cached
    per slot (0 = free slot). ``k_scales``/``v_scales``: (num_layers,
    max_pages, page_size, heads) f32 dequantization scales, present
    only when the pools are int8.
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def max_context(self) -> int:
        return self.page_table.shape[1] * self.page_size

    @property
    def max_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    def clone(self) -> "PagedKVCache":
        """A copy whose pools and table the in-place writes of another
        copy never touch."""
        return PagedKVCache(*(None if t is None else t.clone()
                              for t in self))


def init_cache(num_layers: int, max_slots: int, max_context: int,
               heads: int, head_dim: int, page_size: int = 16,
               max_pages: int = 0, dtype=torch.float32,
               device="cpu") -> PagedKVCache:
    """Allocate the pool on ``device``. ``max_context`` rounds up to
    whole pages; ``max_pages`` defaults to ``max_slots *
    pages_per_slot`` (every slot can reach max_context at once), and the
    table starts as the identity mapping."""
    pages_per_slot = -(-int(max_context) // int(page_size))
    max_pages = int(max_pages) or int(max_slots) * pages_per_slot
    if max_pages < max_slots * pages_per_slot:
        raise ValueError(
            f"max_pages {max_pages} < max_slots*pages_per_slot "
            f"{max_slots * pages_per_slot}; the identity table would "
            f"alias pages")
    shape = (num_layers, max_pages, page_size, heads, head_dim)
    scale_shape = shape[:-1]
    quantized = dtype == torch.int8
    table = torch.arange(max_slots * pages_per_slot, dtype=torch.int32,
                         device=device).reshape(max_slots, pages_per_slot)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_table=table,
        seq_lens=torch.zeros((max_slots,), dtype=torch.int32,
                             device=device),
        k_scales=torch.zeros(scale_shape, device=device)
        if quantized else None,
        v_scales=torch.zeros(scale_shape, device=device)
        if quantized else None)


# symmetric int8 grid: 127 (not 128), so dequantization is one multiply
INT8_QMAX = 127.0


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V rows ``(..., heads, head_dim)`` to int8 with one f32 scale per
    ``(..., heads)``: ``scale = max|x| / 127`` over head_dim, ``q =
    round(x / scale)`` (half to even, as ``jnp.round``). Zero rows get
    scale 0 and dequantize to exact zeros."""
    xf = x.float()
    scale = xf.abs().amax(-1) / INT8_QMAX
    q = torch.round(xf / scale.clamp_min(1e-12)[..., None])
    return q.clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: ``(..., H, D)`` int8 and ``(...,
    H)`` f32 scales back to ``dtype`` values."""
    return (q.float() * scale.float()[..., None]).to(dtype)


Coords = Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]


def _scatter_coords(page_table: torch.Tensor, positions: torch.Tensor,
                    page_size: int, active: torch.Tensor) -> Coords:
    """Where the active (slot, position) rows land: ``(index of the
    active rows in positions' grid, physical page, in-page offset)``.
    Inactive rows are filtered out here, never written anywhere; the
    filter reads ``active`` on the host (one sync on a CUDA tensor),
    once per write however many blocks share it."""
    pages_per_slot = page_table.shape[1]
    s = page_table.shape[0]
    logical = (positions // page_size).clamp(max=pages_per_slot - 1)
    phys = torch.gather(page_table, 1, logical.reshape(s, -1).long()
                        ).reshape(logical.shape)
    offset = positions % page_size
    idx = active.nonzero(as_tuple=True)
    return idx, phys[idx].long(), offset[idx].long()


def _put(pages: torch.Tensor, scales: Optional[torch.Tensor],
         coords: Coords, x: torch.Tensor) -> None:
    """Write the rows of ``x`` at ``coords`` into ``pages`` in place,
    quantized (with their scales) when the pool is int8."""
    idx, phys, offset = coords
    x = x[idx]
    if pages.dtype == torch.int8:
        q, s = quantize_rows(x)
        pages[phys, offset] = q
        scales[phys, offset] = s
    else:
        pages[phys, offset] = x.to(pages.dtype)


def append_coords(page_table: torch.Tensor, seq_lens: torch.Tensor,
                  page_size: int,
                  active: Optional[torch.Tensor] = None) -> Coords:
    """Coordinates of a decode step's writes: each active slot's new
    token at position ``seq_lens[s]``, if that is inside the context."""
    if active is None:
        active = torch.ones_like(seq_lens, dtype=torch.bool)
    max_ctx = page_table.shape[1] * page_size
    active = active & (seq_lens < max_ctx)
    return _scatter_coords(page_table, seq_lens, page_size, active)


def append_layer(k_pages, v_pages, page_table, seq_lens, k_new, v_new,
                 active=None, k_scales=None, v_scales=None,
                 coords: Optional[Coords] = None):
    """Write one decode step's K/V into one block's pool, in place.

    k_pages/v_pages: (P, page, H, D); k_new/v_new: (S, H, D), the new
    token of every slot, written at position ``seq_lens[s]``. Slots
    with ``active == False`` are not written. ``coords`` (from
    :func:`append_coords`) saves recomputing them for every block.
    Returns (k_pages, v_pages), plus (k_scales, v_scales) when scale
    pools are passed (int8 pages)."""
    if coords is None:
        coords = append_coords(page_table, seq_lens, k_pages.shape[1],
                               active)
    _put(k_pages, k_scales, coords, k_new)
    _put(v_pages, v_scales, coords, v_new)
    if k_scales is None:
        return k_pages, v_pages
    return k_pages, v_pages, k_scales, v_scales


def prompt_coords(page_table: torch.Tensor, prompt_lens: torch.Tensor,
                  t: int, page_size: int,
                  start: Optional[torch.Tensor] = None) -> Coords:
    """Coordinates of a prompt write of width ``t``: row j of slot s
    lands at ``start[s] + j`` when that is below ``prompt_lens[s]``
    (the total length after the write) and inside the context."""
    s = page_table.shape[0]
    positions = torch.arange(t, dtype=torch.int32,
                             device=page_table.device)[None, :].expand(s, t)
    if start is not None:
        positions = positions + start.to(torch.int32)[:, None]
    max_ctx = page_table.shape[1] * page_size
    active = (positions < prompt_lens[:, None]) & (positions < max_ctx)
    return _scatter_coords(page_table, positions, page_size, active)


def write_prompt_layer(k_pages, v_pages, page_table, prompt_lens, k_seq,
                       v_seq, start=None, k_scales=None, v_scales=None,
                       coords: Optional[Coords] = None):
    """Write a (right-padded) prompt's K/V for one block, in place.

    k_seq/v_seq: (S, T, H, D). Positions at or past ``prompt_lens[s]``
    are not written, so pad tokens never reach a page a later admission
    may reuse. ``start`` (S,) shifts each slot's window: row j lands at
    ``start[s] + j``, and a slot with ``prompt_lens == 0`` is untouched.
    Scale pools (int8) behave as in :func:`append_layer`."""
    if coords is None:
        coords = prompt_coords(page_table, prompt_lens, k_seq.shape[1],
                               k_pages.shape[1], start)
    _put(k_pages, k_scales, coords, k_seq)
    _put(v_pages, v_scales, coords, v_seq)
    if k_scales is None:
        return k_pages, v_pages
    return k_pages, v_pages, k_scales, v_scales


def gather_layer(pages: torch.Tensor, page_table: torch.Tensor,
                 t_max: int) -> torch.Tensor:
    """Page-table gather to a dense (S, t_max, ...) view of one block's
    pool (positions past a slot's length hold stale or zero rows:
    :func:`length_mask` owns validity). Page ids are clamped into the
    pool, the reference's ``mode="clip"``."""
    page_size = pages.shape[1]
    if t_max % page_size:
        raise ValueError(f"t_max {t_max} not a multiple of page_size "
                         f"{page_size}")
    n = t_max // page_size
    ids = page_table[:, :n].long().clamp(0, pages.shape[0] - 1)
    picked = pages[ids]                      # (S, n, page, ...)
    return picked.reshape((page_table.shape[0], t_max) + pages.shape[2:])


def gather_context(k_pages, v_pages, page_table, t_max: int, dtype,
                   k_scales=None, v_scales=None):
    """One block's K and V gathered to (S, t_max, H, D) for dense
    attention, as the reference's decode step reads them: float pools
    converted to ``dtype``; int8 pools left quantized, with their
    gathered (S, t_max, H) scales. Returns ``(k, v, k_scales,
    v_scales)``, the scales None for float pools."""
    k = gather_layer(k_pages, page_table, t_max)
    v = gather_layer(v_pages, page_table, t_max)
    if k_scales is None:
        return k.to(dtype), v.to(dtype), None, None
    return (k, v, gather_layer(k_scales, page_table, t_max),
            gather_layer(v_scales, page_table, t_max))


def length_mask(seq_lens: torch.Tensor, t: int) -> torch.Tensor:
    """(S, t) bool key-validity mask: position p of slot s is a cached
    token iff ``p < seq_lens[s]``."""
    return torch.arange(t, dtype=torch.int32,
                        device=seq_lens.device)[None, :] < seq_lens[:, None]


# -- KV-page handoff (prefill/decode disaggregation) ----------------------
#
# One sequence's cache state moves between engines as a page gather on
# the source and a page scatter on the destination, never a per-token
# reshape.


def gather_slot_pages(cache: PagedKVCache, page_ids: torch.Tensor):
    """One slot's pages out of every block's pool.

    ``page_ids``: (P,) physical page ids, the slot's table row (entries
    past the used prefix may repeat a real page; the caller keeps the
    used prefix), clamped into the pool. Returns ``(k, v, k_scales,
    v_scales)``: k/v (num_layers, P, page_size, heads, head_dim), scales
    (num_layers, P, page_size, heads) or None for float pools."""
    ids = page_ids.long().clamp(0, cache.k_pages.shape[1] - 1)
    k, v = cache.k_pages[:, ids], cache.v_pages[:, ids]
    if cache.k_scales is None:
        return k, v, None, None
    return k, v, cache.k_scales[:, ids], cache.v_scales[:, ids]


def scatter_slot_pages(cache: PagedKVCache, page_ids, active, slot,
                       seq_len, k_rows, v_rows, k_srows=None,
                       v_srows=None) -> PagedKVCache:
    """Write gathered pages into a destination pool, in place.

    ``page_ids``: (P,) destination physical ids; ``active``: (P,) bool,
    True for the entries to write. The reference routes the others to an
    out-of-range id and drops them; here they are filtered out before
    the write (an out-of-range index is a device assert on CUDA).
    ``k_rows``/``v_rows`` (and scale rows for int8 pools) are
    :func:`gather_slot_pages` outputs of width P. ``seq_lens[slot]``
    becomes ``seq_len``, so the next decode step appends after the
    shipped tokens. The caller writes the destination's page-table row.
    Returns the cache with a new ``seq_lens``."""
    dev = cache.k_pages.device
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    idx = active.nonzero(as_tuple=True)[0]
    phys = torch.as_tensor(page_ids, device=dev).long()[idx]
    cache.k_pages[:, phys] = k_rows[:, idx].to(cache.k_pages.dtype)
    cache.v_pages[:, phys] = v_rows[:, idx].to(cache.v_pages.dtype)
    if cache.k_scales is not None:
        cache.k_scales[:, phys] = k_srows[:, idx].float()
        cache.v_scales[:, phys] = v_srows[:, idx].float()
    seq_lens = cache.seq_lens.clone()
    seq_lens[int(slot)] = int(seq_len)
    return cache._replace(seq_lens=seq_lens)


# A handoff blob is a host dict: one sequence's cache rows (numpy arrays
# sliced to the used page count) and the decode-resume state as plain
# scalars, so it crosses HTTP as JSON. bfloat16 rows are numpy uint16
# arrays of their bit patterns (numpy has no bfloat16 without
# ml_dtypes); the blob's ``kv_dtype`` says "bfloat16", and on the wire
# they carry the reference's ``"dtype": "bfloat16"``, so blobs cross
# between this package and the JAX package both ways.
HANDOFF_VERSION = 1
_WIRE_ARRAYS = ("k", "v", "k_scales", "v_scales")
_BF16 = "bfloat16"


def _arr_to_wire(a, dtype_name: Optional[str] = None) -> dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": dtype_name or a.dtype.name,
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _arr_from_wire(w) -> np.ndarray:
    name = str(w["dtype"])
    dtype = np.uint16 if name == _BF16 else np.dtype(name)
    a = np.frombuffer(base64.b64decode(w["data"]), dtype=dtype)
    return a.reshape([int(d) for d in w["shape"]]).copy()


def handoff_to_wire(blob: dict) -> dict:
    """JSON-safe encoding of a handoff blob: each array becomes ``{shape,
    dtype, data: base64}``; the k/v rows of a bfloat16 blob go as their
    16-bit patterns under dtype "bfloat16"."""
    wire = {k: v for k, v in blob.items() if k not in _WIRE_ARRAYS}
    for name in _WIRE_ARRAYS:
        a = blob.get(name)
        bf16 = name in ("k", "v") and blob.get("kv_dtype") == _BF16
        wire[name] = None if a is None else _arr_to_wire(
            np.asarray(a).view(np.uint16) if bf16 else a,
            _BF16 if bf16 else None)
    return wire


def handoff_from_wire(wire: dict) -> dict:
    """Inverse of :func:`handoff_to_wire`, bit for bit (bfloat16 rows
    come back as uint16 bit patterns)."""
    blob = {k: v for k, v in wire.items() if k not in _WIRE_ARRAYS}
    for name in _WIRE_ARRAYS:
        w = wire.get(name)
        blob[name] = None if w is None else _arr_from_wire(w)
    return blob


def handoff_nbytes(blob: dict) -> int:
    """Payload bytes of the blob's arrays (the wire-cost metric)."""
    return sum(int(np.asarray(blob[n]).nbytes) for n in _WIRE_ARRAYS
               if blob.get(n) is not None)


def rows_to_host(t: torch.Tensor) -> np.ndarray:
    """A cache-row tensor as the blob's numpy array: bfloat16 as its
    uint16 bit patterns, other types as they are."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def rows_from_host(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of :func:`rows_to_host` for a pool of ``dtype``: a
    bfloat16 pool reads any 2-byte array (uint16 bit patterns, or an
    ``ml_dtypes`` bfloat16 array from the JAX package) as bit patterns."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


class PageAllocator:
    """Host-side free list over the physical page pool. Not thread-safe
    by itself: the engine's single caller serialises access."""

    def __init__(self, max_pages: int):
        self.max_pages = int(max_pages)
        self._free = list(range(self.max_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> "list[int]":
        """Pop ``n`` physical page ids; raises MemoryError when the pool
        cannot satisfy the request (callers check :meth:`can_alloc`)."""
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have "
                f"{len(self._free)} of {self.max_pages}")
        if n <= 0:
            return []
        out = self._free[-n:][::-1]
        del self._free[-n:]
        return out

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 <= p < self.max_pages:
                raise ValueError(f"bad page id {p}")
        self._free.extend(pages)

    @staticmethod
    def pages_needed(tokens: int, page_size: int) -> int:
        return -(-int(tokens) // int(page_size))
