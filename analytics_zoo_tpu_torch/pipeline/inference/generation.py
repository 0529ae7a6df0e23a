"""Generation serving engine: the resident decode state for
autoregressive generation (port of
``analytics_zoo_tpu/pipeline/inference/generation.py``, whole-prompt
path).

The model layer owns the math (``TransformerLayer.prefill`` /
``decode_step`` / ``generate``); this module owns what a server needs
around it:

- one resident :class:`~analytics_zoo_tpu_torch.ops.kv_cache.PagedKVCache`
  of ``(max_slots, max_context)`` on the card, with the host-side
  ``PageAllocator`` assigning physical pages at admission and
  reclaiming them at retirement;
- one decode step over the full slot array (inactive slots frozen by
  the ``active`` mask) and one prefill per prompt-length bucket (the
  bucket ladder of ``batching.py``), both run eagerly; :meth:`warm`
  runs each once before traffic so kernels are built and memory is
  allocated;
- per-slot sampling state: a host ``(max_slots,)`` temperature vector
  and a ``top_k`` (``ZOO_TPU_GEN_TOP_K``); step i draws with
  ``fold_in(rng_seed, i)`` (``ops/rng.py``);
- a sequential :meth:`generate`, the per-request baseline.

The engine is not thread-safe: one caller (the ``ContinuousBatcher``'s
loop thread, or a caller of :meth:`generate`) touches it at a time.

Configuration (constructor kwargs override the environment):
``ZOO_TPU_GEN_SLOTS`` (8), ``ZOO_TPU_GEN_MAX_CONTEXT`` (the net's
``seq_len``), ``ZOO_TPU_GEN_PAGE_SIZE`` (16), ``ZOO_TPU_GEN_TOP_K`` (0 =
full softmax), ``ZOO_TPU_KV_DTYPE`` (f32, bf16 or int8). Chunked
prefill (``ZOO_TPU_PREFILL_CHUNK``), speculative decoding
(``ZOO_TPU_SPEC_K``) and the disaggregated roles are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops import kv_cache as kvc
from analytics_zoo_tpu_torch.ops.rng import fold_in
from analytics_zoo_tpu_torch.ops.sampling import sample_tokens
from analytics_zoo_tpu_torch.pipeline.inference.batching import \
    bucket_ladder

__all__ = ["GenerationEngine", "resolve_kv_dtype"]

_KV_DTYPES = ("f32", "bf16", "int8")


def resolve_kv_dtype(cache_dtype=None) -> torch.dtype:
    """The paged cache's storage dtype: an explicit dtype (or its name)
    wins, else ``ZOO_TPU_KV_DTYPE`` (default f32; bf16 halves the pool,
    int8 halves it again with per-row scales)."""
    named = {"f32": torch.float32, "float32": torch.float32,
             "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "int8": torch.int8}
    if cache_dtype is None:
        cache_dtype = os.environ.get("ZOO_TPU_KV_DTYPE", "f32")
    if isinstance(cache_dtype, str):
        if cache_dtype not in named:
            raise ValueError(f"ZOO_TPU_KV_DTYPE {cache_dtype!r} not one "
                             f"of {_KV_DTYPES}")
        return named[cache_dtype]
    return cache_dtype


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, A12 generation: queued "
        f"after the whole-prompt path)")


class GenerationEngine:
    """Resident decode state for one generative net.

    ``net`` exposes ``init_kv_cache / prefill / decode_step / generate``
    and ``seq_len`` / ``vocab`` (the transformer layer does). ``params``
    is its param tree (tensors or host arrays), moved to ``device``
    (default: the context's, the card).
    """

    def __init__(self, net, params, *,
                 max_slots: Optional[int] = None,
                 max_context: Optional[int] = None,
                 page_size: Optional[int] = None,
                 top_k: Optional[int] = None,
                 cache_dtype=None,
                 prefill_chunk: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 rng_seed: int = 0,
                 role: str = "both",
                 device=None):
        from analytics_zoo_tpu_torch.bridge import params_from_numpy
        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

        env = os.environ
        if max_slots is None:
            max_slots = int(env.get("ZOO_TPU_GEN_SLOTS", 8))
        if max_context is None:
            max_context = int(env.get("ZOO_TPU_GEN_MAX_CONTEXT",
                                      net.seq_len))
        if page_size is None:
            page_size = int(env.get("ZOO_TPU_GEN_PAGE_SIZE", 16))
        if top_k is None:
            top_k = int(env.get("ZOO_TPU_GEN_TOP_K", 0))
        if prefill_chunk is None:
            prefill_chunk = int(env.get("ZOO_TPU_PREFILL_CHUNK", 0))
        if spec_k is None:
            spec_k = int(env.get("ZOO_TPU_SPEC_K", 0))
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role {role!r} not one of 'prefill'/'decode'/'both'")
        if prefill_chunk > 0:
            _not_ported("chunked prefill (prefill_chunk > 0)")
        if spec_k > 0:
            _not_ported("speculative decoding (spec_k > 0)")
        if role != "both":
            _not_ported(f"the disaggregated role {role!r}")
        if max_context > net.seq_len:
            raise ValueError(
                f"max_context {max_context} exceeds the net's position "
                f"table ({net.seq_len})")
        self.device = torch.device(device) if device is not None else \
            get_nncontext().device
        self.net = net
        self.params = params_from_numpy(params, self.device)
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.top_k = int(top_k)
        self.cache_dtype = resolve_kv_dtype(cache_dtype)
        self.role = role

        cache = net.init_kv_cache(self.max_slots, int(max_context),
                                  page_size=self.page_size,
                                  dtype=self.cache_dtype,
                                  device=self.device)
        self.max_context = cache.max_context  # whole pages
        self.pages_per_slot = cache.page_table.shape[1]
        # the engine owns page placement: blank the identity table and
        # hand every physical page to the allocator
        self._table = np.zeros((self.max_slots, self.pages_per_slot),
                               np.int32)
        cache.page_table.zero_()
        self.cache = cache
        self.allocator = kvc.PageAllocator(cache.k_pages.shape[1])
        self._slot_pages: "dict[int, list]" = {}
        self.free_slots = set(range(self.max_slots))

        self._temps = np.zeros((self.max_slots,), np.float32)
        self._last_tok = np.zeros((self.max_slots,), np.int32)
        self._seed = int(rng_seed)
        self._step_id = 0
        self.prompt_buckets = bucket_ladder(
            min(self.max_context, int(net.seq_len)))
        self._warmed_programs: set = set()

    # -- the two programs -----------------------------------------------------
    def _run_prefill(self, cache, ids: np.ndarray, plens: np.ndarray):
        with torch.no_grad():
            cache, logits = self.net.prefill(
                self.params, cache, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(plens).to(self.device))
            toks = sample_tokens(fold_in(self._seed, self._step_id),
                                 logits, self._temps, self.top_k)
        self._warmed_programs.add(("prefill", ids.shape[1]))
        return cache, toks

    def _run_step(self, cache, active: np.ndarray):
        with torch.no_grad():
            cache, logits = self.net.decode_step(
                self.params, cache,
                torch.from_numpy(self._last_tok).to(self.device),
                active=torch.from_numpy(active).to(self.device))
            toks = sample_tokens(fold_in(self._seed, self._step_id),
                                 logits, self._temps, self.top_k)
        self._warmed_programs.add(("step",))
        return cache, toks

    def warm(self) -> int:
        """Run every program steady-state serving needs once (each
        prompt bucket's prefill, then the decode step) on a scratch copy
        of the cache with an identity table, so kernels are built and
        memory is allocated before traffic. Returns how many programs
        ran for the first time; a second call runs none. Capturing the
        step in a CUDA graph is later work (ROADMAP, A12)."""
        n0 = len(self._warmed_programs)
        if n0 == len(self.prompt_buckets) + 1:
            return 0
        scratch = self.cache.clone()
        scratch.page_table.copy_(torch.arange(
            self.max_slots * self.pages_per_slot,
            dtype=torch.int32).reshape(self.max_slots, -1))
        for tp in self.prompt_buckets:
            ids = np.ones((self.max_slots, tp), np.int32)
            plens = np.full((self.max_slots,), min(tp, self.max_context - 1),
                            np.int32)
            scratch, _ = self._run_prefill(scratch, ids, plens)
        active = np.ones((self.max_slots,), np.bool_)
        _, toks = self._run_step(scratch, active)
        toks.cpu()
        del scratch
        return len(self._warmed_programs) - n0

    # -- admission / stepping / retirement ------------------------------------
    def pages_for(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page reservation for one request (prompt + max_new
        tokens, capped at the context window)."""
        return kvc.PageAllocator.pages_needed(
            min(prompt_len + max_new, self.max_context), self.page_size)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """Whether a request fits now: a free slot and enough free pages
        for its worst case. Pages are reserved in full at admission, so
        an admitted sequence always runs to completion."""
        return bool(self.free_slots) and self.allocator.can_alloc(
            self.pages_for(prompt_len, max_new))

    def admit(self, requests: "Sequence[tuple]") -> "list[tuple]":
        """Admit ``[(prompt_ids, max_new, temperature), ...]`` into free
        slots of the live batch: assign pages, write the table rows, run
        one bucket-padded prefill (the other slots pass ``prompt_lens ==
        0`` and are untouched) and sample each new slot's first token.
        Returns ``[(slot, first_token), ...]``. Raises MemoryError when
        slots or pages run out (callers gate with :meth:`can_admit`)."""
        if not requests:
            return []
        for prompt_ids, _, _ in requests:
            if not 1 <= len(prompt_ids) <= self.max_context - 1:
                raise ValueError(
                    f"prompt length {len(prompt_ids)} outside [1, "
                    f"{self.max_context - 1}]")
        tp = max(len(r[0]) for r in requests)
        tp = next(b for b in self.prompt_buckets if b >= tp)
        ids = np.zeros((self.max_slots, tp), np.int32)
        plens = np.zeros((self.max_slots,), np.int32)
        admitted = []
        for prompt_ids, max_new, temperature in requests:
            slot = self._claim_slot(prompt_ids, max_new, temperature)
            n = len(prompt_ids)
            ids[slot, :n] = np.asarray(prompt_ids, np.int32)
            plens[slot] = n
            admitted.append(slot)
        self._push_table()
        self.cache, toks = self._run_prefill(self.cache, ids, plens)
        self._step_id += 1
        toks = toks.cpu().numpy()
        out = []
        for slot in admitted:
            self._last_tok[slot] = toks[slot]
            out.append((slot, int(toks[slot])))
        return out

    def _claim_slot(self, prompt_ids, max_new, temperature) -> int:
        """Allocate pages, a slot and its table row for one request."""
        need = self.pages_for(len(prompt_ids), int(max_new))
        if not self.free_slots:
            raise MemoryError("no free decode slot")
        pages = self.allocator.alloc(need)  # MemoryError if short
        slot = min(self.free_slots)
        self.free_slots.discard(slot)
        self._slot_pages[slot] = pages
        row = np.full((self.pages_per_slot,), pages[-1], np.int32)
        row[:need] = pages
        self._table[slot] = row
        self._temps[slot] = float(temperature)
        return slot

    def _push_table(self):
        """Publish the host page table to the cache on the card."""
        self.cache.page_table.copy_(torch.from_numpy(self._table))

    def step(self, active) -> np.ndarray:
        """One decode iteration over the whole slot array: append each
        active slot's last token, attend, sample. Slots with ``active ==
        False`` are frozen. Returns the ``(max_slots,)`` sampled tokens,
        meaningful at active slots only."""
        active = np.asarray(active, np.bool_)
        self.cache, toks = self._run_step(self.cache, active)
        self._step_id += 1
        toks = toks.cpu().numpy()
        self._last_tok = np.where(active, toks, self._last_tok
                                  ).astype(np.int32)
        return toks

    def release(self, slot: int):
        """Retire a slot: reclaim its pages and free it. Its cache rows
        need no reset: a later prefill overwrites ``seq_lens``, and
        until then the ``active`` mask keeps the slot frozen."""
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self.allocator.free(pages)
        self.free_slots.add(slot)

    @property
    def slots_active(self) -> int:
        return self.max_slots - len(self.free_slots)

    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages

    # -- sequential whole-loop path -------------------------------------------
    def generate(self, prompts, max_new_tokens: int = 32, *,
                 temperature: float = 0.0, eos_id=None, rng=None
                 ) -> "list[np.ndarray]":
        """Per-request generation through the model's whole loop on a
        fresh cache (the sequential baseline; concurrent traffic goes
        through the continuous batcher). Returns one array of newly
        generated ids per prompt (eos included when hit)."""
        if prompts and np.isscalar(prompts[0]):
            prompts = [prompts]
        s = len(prompts)
        tp = max(len(p) for p in prompts)
        tp = next((b for b in self.prompt_buckets if b >= tp), tp)
        ids = np.zeros((s, tp), np.int32)
        plens = np.zeros((s,), np.int32)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = np.asarray(p, np.int32)
            plens[i] = len(p)
        with torch.no_grad():
            buf, lens = self.net.generate(
                self.params, ids, prompt_lens=plens,
                max_new_tokens=int(max_new_tokens),
                temperature=np.full((s,), float(temperature), np.float32),
                top_k=self.top_k, eos_id=eos_id,
                rng=self._seed if rng is None else rng,
                page_size=self.page_size, cache_dtype=self.cache_dtype)
        buf, lens = buf.cpu().numpy(), lens.cpu().numpy()
        return [buf[i, plens[i]:lens[i]] for i in range(s)]

    def stats(self) -> dict:
        """JSON-able summary."""
        return {
            "role": self.role,
            "max_slots": self.max_slots,
            "slots_active": self.slots_active,
            "max_context": self.max_context,
            "page_size": self.page_size,
            "free_pages": self.free_pages,
            "total_pages": self.allocator.max_pages,
            "prompt_buckets": list(self.prompt_buckets),
            "warmed_programs": len(self._warmed_programs),
            "kv_dtype": str(self.cache.k_pages.dtype).split(".")[-1],
            # the reference's keys; both features are refused above
            "prefill_chunk": 0,
            "spec_k": 0,
        }

    def __repr__(self):
        return (f"GenerationEngine(slots={self.max_slots}, "
                f"context={self.max_context}, "
                f"page_size={self.page_size}, "
                f"free_pages={self.free_pages})")
