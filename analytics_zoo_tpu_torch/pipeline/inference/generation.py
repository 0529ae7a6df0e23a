"""Generation serving engine: the resident decode state for
autoregressive generation (port of
``analytics_zoo_tpu/pipeline/inference/generation.py``).

The model layer owns the math (``TransformerLayer.prefill`` /
``decode_step`` / ``forward_chunk`` / ``generate``); this module owns
what a server needs around it:

- one resident :class:`~analytics_zoo_tpu_torch.ops.kv_cache.PagedKVCache`
  of ``(max_slots, max_context)`` on the card, with the host-side
  ``PageAllocator`` assigning physical pages at admission and
  reclaiming them at retirement;
- one decode step over the full slot array (inactive slots frozen by
  the ``active`` mask) and one prefill per prompt-length bucket (the
  bucket ladder of ``batching.py``), both run eagerly; :meth:`warm`
  runs every program the engine's role and levers need once before
  traffic, so kernels are built and memory is allocated;
- per-slot sampling state: a host ``(max_slots,)`` temperature vector
  and a ``top_k`` (``ZOO_TPU_GEN_TOP_K``); program i draws with
  ``fold_in(rng_seed, i)`` (``ops/rng.py``);
- a sequential :meth:`generate`, the per-request baseline.

Three capacity levers, each off by default:

- **Chunked prefill** (``ZOO_TPU_PREFILL_CHUNK`` = chunk width C, 0 =
  off): :meth:`admit_partial` assigns slots and pages without running
  the prompt; :meth:`prefill_step` then advances every prefilling slot
  by at most C prompt tokens through ``forward_chunk``, so the batcher
  interleaves one bounded chunk with each decode iteration and a long
  prompt never stalls the resident sequences for longer than a chunk.
- **Speculative decoding** (``ZOO_TPU_SPEC_K`` = draft length k, 0 =
  off; needs a ``drafter`` net sharing the vocabulary): the drafter
  proposes k tokens (k drafter decode steps), the target scores them in
  one ``forward_chunk(all_logits=True)`` and
  ``ops.sampling.speculative_accept`` keeps a prefix: exact for greedy,
  the target's distribution when sampling. Both caches rewind
  ``seq_lens`` to the accepted length (rows past a length are
  invisible), and the drafter's pool mirrors the target's page table
  in a table of its own, so page accounting is unchanged.
- **Prefill/decode roles** (``role="prefill"`` / ``"decode"``): a
  prefill engine exports a sequence's pages and resume state as a
  handoff blob at its first token (:meth:`export_handoff`, pages
  reclaimed at once); a decode engine splices the blob into its own
  pool with no forward pass (:meth:`admit_from_handoff`) and continues
  the stream token for token. Speculation stays with ``role="both"``.

The engine is not thread-safe: one caller (the ``ContinuousBatcher``'s
loop thread, or a caller of :meth:`generate`) touches it at a time. The
fault point ``generation/decode_step`` (``common/faults.py``) fires at
the head of :meth:`step` and :meth:`spec_step`.

Configuration (constructor kwargs override the environment):
``ZOO_TPU_GEN_SLOTS`` (8), ``ZOO_TPU_GEN_MAX_CONTEXT`` (the net's
``seq_len``), ``ZOO_TPU_GEN_PAGE_SIZE`` (16), ``ZOO_TPU_GEN_TOP_K`` (0 =
full softmax), ``ZOO_TPU_KV_DTYPE`` (f32, bf16 or int8),
``ZOO_TPU_PREFILL_CHUNK`` (0) and ``ZOO_TPU_SPEC_K`` (0).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.ops import kv_cache as kvc
from analytics_zoo_tpu_torch.ops.rng import fold_in
from analytics_zoo_tpu_torch.ops.sampling import (sample_tokens,
                                                  sampling_probs,
                                                  speculative_accept)
from analytics_zoo_tpu_torch.pipeline.inference.batching import \
    bucket_ladder

__all__ = ["GenerationEngine", "resolve_kv_dtype"]

# chaos hook: a "kill" here is the device dying mid-decode with resident
# sequences holding pages
_STEP_FAULT = faults.point("generation/decode_step")

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


class GenerationEngine:
    """Resident decode state for one generative net.

    ``net`` exposes ``init_kv_cache / prefill / decode_step /
    forward_chunk / generate`` and ``seq_len`` / ``vocab`` (the
    transformer layer does). ``params`` is its param tree (tensors or
    host arrays), moved to ``device`` (default: the context's, the
    card). A ``drafter`` (the same surface and vocabulary, typically
    smaller) with ``drafter_params`` and ``spec_k > 0`` turns on
    speculative decoding.
    """

    def __init__(self, net, params, *,
                 max_slots: Optional[int] = None,
                 max_context: Optional[int] = None,
                 page_size: Optional[int] = None,
                 top_k: Optional[int] = None,
                 cache_dtype=None,
                 prefill_chunk: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 drafter=None, drafter_params=None,
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
        if max_context > net.seq_len:
            raise ValueError(
                f"max_context {max_context} exceeds the net's position "
                f"table ({net.seq_len})")
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role {role!r} not one of 'prefill'/'decode'/'both'")
        self.prefill_chunk = max(0, int(prefill_chunk))
        self.spec_k = max(0, int(spec_k))
        if self.spec_k > 0 and drafter is None:
            raise ValueError(
                "spec_k > 0 needs a drafter net (load_generator"
                "(..., drafter=..., drafter_params=...))")
        if self.spec_k > 0 and role != "both":
            # the drafter's cache cannot be rebuilt from a handoff blob
            # without its own forward pass
            raise ValueError(
                "speculative decoding (spec_k > 0) is incompatible "
                "with disaggregated roles; use role='both'")
        if self.spec_k > 1_000:
            raise ValueError(f"spec_k {self.spec_k} is absurd")
        self.page_size = int(page_size)
        # whole pages, as the cache rounds it
        context = -(-int(max_context) // self.page_size) * self.page_size
        speculating = drafter is not None and self.spec_k > 0
        if speculating:
            if int(drafter.vocab) != int(net.vocab):
                raise ValueError(f"drafter vocab {drafter.vocab} != target "
                                 f"vocab {net.vocab}")
            if context > drafter.seq_len:
                raise ValueError(
                    f"max_context {context} exceeds the drafter's position "
                    f"table ({drafter.seq_len})")
        self.device = torch.device(device) if device is not None else \
            get_nncontext().device
        self.net = net
        self.params = params_from_numpy(params, self.device)
        self.max_slots = int(max_slots)
        self.top_k = int(top_k)
        self.cache_dtype = resolve_kv_dtype(cache_dtype)
        self.role = role

        cache = net.init_kv_cache(self.max_slots, int(max_context),
                                  page_size=self.page_size,
                                  dtype=self.cache_dtype,
                                  device=self.device)
        self.max_context = cache.max_context
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

        # the drafter: a pool of its own with the target's slot and page
        # geometry, and a table tensor of its own that _push_table keeps
        # equal to the target's (writes are in place, so the two caches
        # share no tensor); draft and verify rewind both lengths together
        self.drafter = drafter
        self.drafter_params = None
        self._draft_cache = None
        if speculating:
            self.drafter_params = params_from_numpy(drafter_params,
                                                    self.device)
            dcache = drafter.init_kv_cache(
                self.max_slots, int(max_context), page_size=self.page_size,
                dtype=self.cache_dtype, device=self.device)
            dcache.page_table.zero_()
            self._draft_cache = dcache

        self._temps = np.zeros((self.max_slots,), np.float32)
        self._last_tok = np.zeros((self.max_slots,), np.int32)
        self._seed = int(rng_seed)
        self._step_id = 0
        # chunked prefill: slot -> [prompt ids, next offset] for prompts
        # admitted but not yet wholly in the cache
        self._pending_prompts: "dict[int, list]" = {}
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prompt_buckets = bucket_ladder(
            min(self.max_context, int(net.seq_len)))
        self._warmed_programs: set = set()

    # -- the programs ---------------------------------------------------------
    # Each runs one forward (or one handoff half) on the caches it is
    # given and returns them; they read the engine's params, temperatures
    # and top_k but change no engine state beyond the caches, so warm()
    # can run them on scratch copies.

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _ran(self, *program):
        self._warmed_programs.add(program)

    def _prefill_fn(self, cache, ids, plens, seed):
        cache, logits = self.net.prefill(self.params, cache, self._dev(ids),
                                         self._dev(plens))
        self._ran("prefill", ids.shape[1])
        return cache, sample_tokens(seed, logits, self._temps, self.top_k)

    def _step_fn(self, cache, tok, active, seed):
        cache, logits = self.net.decode_step(self.params, cache, tok,
                                             active=active)
        self._ran("step")
        return cache, sample_tokens(seed, logits, self._temps, self.top_k)

    def _chunk_fn(self, cache, ids, starts, n_new, seed):
        cache, logits = self.net.forward_chunk(
            self.params, cache, self._dev(ids), self._dev(starts),
            self._dev(n_new))
        self._ran("chunk")
        return cache, sample_tokens(seed, logits, self._temps, self.top_k)

    def _draft_prefill_fn(self, dcache, ids, plens):
        dcache, _ = self.drafter.prefill(self.drafter_params, dcache,
                                         self._dev(ids), self._dev(plens))
        self._ran("draft_prefill", ids.shape[1])
        return dcache

    def _draft_chunk_fn(self, dcache, ids, starts, n_new):
        dcache, _ = self.drafter.forward_chunk(
            self.drafter_params, dcache, self._dev(ids), self._dev(starts),
            self._dev(n_new))
        self._ran("draft_chunk")
        return dcache

    def _draft_fn(self, dcache, t0, active, seed):
        """Propose ``spec_k`` tokens per active slot: k drafter decode
        steps, each sampling with the slot's own temperature and top_k
        and keeping that distribution q for the accept test. Consumes
        [t0, d1, ..., d_{k-1}]; returns ``(dcache, drafts (S, K), q (S,
        K, V))``."""
        drafts, qs, tok = [], [], t0
        for i in range(self.spec_k):
            dcache, logits = self.drafter.decode_step(
                self.drafter_params, dcache, tok, active=active)
            logits = logits.float()
            tok = sample_tokens(fold_in(seed, i), logits, self._temps,
                                self.top_k)
            drafts.append(tok)
            qs.append(sampling_probs(logits, self._temps, self.top_k))
        self._ran("draft")
        return dcache, torch.stack(drafts, 1), torch.stack(qs, 1)

    def _verify_fn(self, cache, dcache, t0, drafts, qprobs, active, seed):
        """Score the k drafts with the target in one
        ``forward_chunk(all_logits=True)``, accept a prefix by rejection
        sampling and rewind both caches' lengths to it. The chunk
        consumes [t0, d1, ..., d_{k-1}], the tokens the drafter consumed,
        so both caches stay row for row in step, and a full acceptance
        leaves dk pending. Returns ``(cache, dcache, out (S, K), n_accept,
        n_emit, next_tok)``."""
        k = self.spec_k
        toks = torch.cat([t0[:, None], drafts[:, :k - 1]], dim=1)
        starts = cache.seq_lens
        n_new = torch.where(active, k, 0).to(torch.int32)
        cache, logits = self.net.forward_chunk(self.params, cache, toks,
                                               starts, n_new,
                                               all_logits=True)
        temps = np.repeat(self._temps[:, None], k, axis=1)
        p = sampling_probs(logits.float(), temps, self.top_k)
        n_acc, corrected = speculative_accept(seed, p, qprobs, drafts)
        # emitted: the accepted prefix, then the corrected token after a
        # rejection; a full acceptance emits the k drafts and keeps dk
        # pending. Either way the caches hold exactly the consumed rows.
        n_emit = (n_acc + 1).clamp(max=k)
        idx = torch.arange(k, device=drafts.device)[None, :]
        out = torch.where(idx < n_acc[:, None], drafts, corrected[:, None])
        nxt = torch.where(n_acc == k, drafts[:, -1], corrected)
        new_len = starts + torch.where(active, n_emit, 0)
        cache = cache._replace(seq_lens=torch.where(active, new_len,
                                                    cache.seq_lens))
        dcache = dcache._replace(seq_lens=torch.where(active, new_len,
                                                      dcache.seq_lens))
        self._ran("verify")
        return cache, dcache, out, n_acc, n_emit, nxt

    def _programs(self) -> "list[tuple]":
        """The programs steady-state serving runs under this role and
        these levers: a prefill engine never steps, a decode engine
        never prefills, and each lever adds its own."""
        progs = []
        if self.role != "decode":
            progs += [("prefill", tp) for tp in self.prompt_buckets]
            if self.prefill_chunk > 0:
                progs.append(("chunk",))
        if self.role != "prefill":
            progs.append(("step",))
        if self.role == "prefill":
            progs.append(("handoff_export",))
        if self.role == "decode":
            progs.append(("handoff_import",))
        if self._draft_cache is not None:
            progs += [("draft",), ("verify",)]
            if self.prefill_chunk > 0:
                progs.append(("draft_chunk",))
            # prompts that fit one chunk admit through the buckets even
            # under chunking, so the drafter's buckets are always needed
            progs += [("draft_prefill", tp) for tp in self.prompt_buckets]
        return progs

    def warm(self) -> int:
        """Run every program of :meth:`_programs` once on scratch copies
        of the caches with identity tables, so kernels are built and
        memory is allocated before traffic. Returns how many programs
        ran for the first time; a second call runs none. Capturing the
        step in a CUDA graph is later work (ROADMAP, A12)."""
        n0 = len(self._warmed_programs)
        todo = [p for p in self._programs()
                if p not in self._warmed_programs]
        if not todo:
            return 0
        s, ctx = self.max_slots, self.max_context
        identity = torch.arange(s * self.pages_per_slot, dtype=torch.int32,
                                device=self.device).reshape(s, -1)

        def scratch_of(cache):
            c = cache.clone()
            c.page_table.copy_(identity)
            return c
        scratch = scratch_of(self.cache)
        dscratch = None if self._draft_cache is None else \
            scratch_of(self._draft_cache)
        seed = fold_in(self._seed, -1)
        with torch.no_grad():
            for prog in todo:
                if prog[0] in ("prefill", "draft_prefill"):
                    ids = np.ones((s, prog[1]), np.int32)
                    plens = np.full((s,), min(prog[1], ctx - 1), np.int32)
                    if prog[0] == "prefill":
                        scratch, _ = self._prefill_fn(scratch, ids, plens,
                                                      seed)
                    else:
                        dscratch = self._draft_prefill_fn(dscratch, ids,
                                                          plens)
                elif prog[0] in ("chunk", "draft_chunk"):
                    c = self.prefill_chunk
                    ids = np.ones((s, c), np.int32)
                    starts = np.zeros((s,), np.int32)
                    n_new = np.full((s,), min(c, ctx - 1), np.int32)
                    if prog[0] == "chunk":
                        scratch, _ = self._chunk_fn(scratch, ids, starts,
                                                    n_new, seed)
                    else:
                        dscratch = self._draft_chunk_fn(dscratch, ids,
                                                         starts, n_new)
            # the steps append after one cached token per slot
            one = torch.ones((s,), dtype=torch.int32, device=self.device)
            scratch = scratch._replace(seq_lens=one)
            active = torch.ones((s,), dtype=torch.bool, device=self.device)
            tok = torch.ones((s,), dtype=torch.int32, device=self.device)
            for prog in todo:
                if prog == ("step",):
                    self._step_fn(scratch, tok, active, seed)
                    scratch = scratch._replace(seq_lens=one)
                elif prog == ("draft",):
                    dscratch = dscratch._replace(seq_lens=one)
                    dscratch, drafts, q = self._draft_fn(dscratch, tok,
                                                         active, seed)
                    self._verify_fn(scratch, dscratch, tok, drafts, q,
                                    active, seed)
                elif prog[0] == "handoff_export":
                    kvc.gather_slot_pages(scratch, identity[0])
                    self._ran("handoff_export")
                elif prog[0] == "handoff_import":
                    rows = kvc.gather_slot_pages(scratch, identity[0])
                    kvc.scatter_slot_pages(
                        scratch, identity[0],
                        np.ones((self.pages_per_slot,), np.bool_), 0, 1,
                        *rows)
                    self._ran("handoff_import")
            scratch.seq_lens.cpu()      # waits for the card
        del scratch, dscratch
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

    def _check_prompts(self, requests):
        for prompt_ids, _, _ in requests:
            if not 1 <= len(prompt_ids) <= self.max_context - 1:
                raise ValueError(
                    f"prompt length {len(prompt_ids)} outside [1, "
                    f"{self.max_context - 1}]")

    def admit(self, requests: "Sequence[tuple]") -> "list[tuple]":
        """Admit ``[(prompt_ids, max_new, temperature), ...]`` into free
        slots of the live batch: assign pages, write the table rows, run
        one bucket-padded prefill (the other slots pass ``prompt_lens ==
        0`` and are untouched; the drafter's too, under speculation) and
        sample each new slot's first token. Returns ``[(slot,
        first_token), ...]``. Raises MemoryError when slots or pages run
        out (callers gate with :meth:`can_admit`)."""
        if not requests:
            return []
        self._check_prompts(requests)
        tp = max(len(r[0]) for r in requests)
        tp = next(b for b in self.prompt_buckets if b >= tp)
        ids = np.zeros((self.max_slots, tp), np.int32)
        plens = np.zeros((self.max_slots,), np.int32)
        admitted = []
        for prompt_ids, max_new, temperature in requests:
            slot = self._claim(len(prompt_ids), max_new, temperature)
            n = len(prompt_ids)
            ids[slot, :n] = np.asarray(prompt_ids, np.int32)
            plens[slot] = n
            admitted.append(slot)
        self._push_table()
        with torch.no_grad():
            self.cache, toks = self._prefill_fn(
                self.cache, ids, plens, fold_in(self._seed, self._step_id))
            if self._draft_cache is not None:
                self._draft_cache = self._draft_prefill_fn(
                    self._draft_cache, ids, plens)
        self._step_id += 1
        toks = toks.cpu().numpy()
        out = []
        for slot in admitted:
            self._last_tok[slot] = toks[slot]
            out.append((slot, int(toks[slot])))
        return out

    def _claim(self, tokens: int, max_new, temperature) -> int:
        """Allocate pages, a slot and its table row for a sequence of
        ``tokens`` cached tokens and ``max_new`` more."""
        need = self.pages_for(tokens, int(max_new))
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
        """Publish the host page table to the cache on the card, and to
        the drafter's, which mirrors it."""
        table = torch.from_numpy(self._table)
        self.cache.page_table.copy_(table)
        if self._draft_cache is not None:
            self._draft_cache.page_table.copy_(table)

    # -- chunked prefill ------------------------------------------------------
    def admit_partial(self, requests: "Sequence[tuple]") -> "list[int]":
        """Chunked admission: give each request a slot, pages and a table
        row but run no forward pass. The prompt waits in the chunk
        scheduler, and :meth:`prefill_step` writes it ``prefill_chunk``
        tokens at a time. Returns the slots (their first tokens come from
        the prefill_step that lands each prompt's last chunk). Gated as
        :meth:`admit` is."""
        if self.prefill_chunk <= 0:
            raise ValueError("admit_partial needs prefill_chunk > 0")
        self._check_prompts(requests)
        slots = []
        for prompt_ids, max_new, temperature in requests:
            slot = self._claim(len(prompt_ids), max_new, temperature)
            self._pending_prompts[slot] = [
                np.asarray(prompt_ids, np.int32), 0]
            slots.append(slot)
        if slots:
            self._push_table()
        return slots

    @property
    def prefilling_slots(self) -> "set[int]":
        """Slots admitted by :meth:`admit_partial` whose prompts are not
        wholly cached yet (they take no decode step)."""
        return set(self._pending_prompts)

    def cancel_prefill(self, slot: int):
        """Forget a mid-prefill slot's pending prompt (drain, cancel); the
        caller releases its pages with :meth:`release`. The rows its
        chunks wrote are dead: its length stops and a later occupant
        overwrites them."""
        self._pending_prompts.pop(slot, None)

    def prefill_step(self) -> "list[tuple]":
        """Advance every prefilling slot by one chunk (at most
        ``prefill_chunk`` prompt tokens), the drafter's cache too. Slots
        whose last chunk just landed sample their first token: returns
        ``[(slot, first_token), ...]`` for exactly those; [] when nothing
        is prefilling."""
        if not self._pending_prompts:
            return []
        c = self.prefill_chunk
        ids = np.zeros((self.max_slots, c), np.int32)
        starts = np.zeros((self.max_slots,), np.int32)
        n_new = np.zeros((self.max_slots,), np.int32)
        finishing = []
        for slot, (prompt, off) in self._pending_prompts.items():
            n = min(c, len(prompt) - off)
            ids[slot, :n] = prompt[off:off + n]
            starts[slot] = off
            n_new[slot] = n
            if off + n >= len(prompt):
                finishing.append(slot)
        with torch.no_grad():
            self.cache, toks = self._chunk_fn(
                self.cache, ids, starts, n_new,
                fold_in(self._seed, self._step_id))
            if self._draft_cache is not None:
                self._draft_cache = self._draft_chunk_fn(
                    self._draft_cache, ids, starts, n_new)
        self._step_id += 1
        toks = toks.cpu().numpy()
        for slot in list(self._pending_prompts):
            if slot in finishing:
                del self._pending_prompts[slot]
            else:
                self._pending_prompts[slot][1] += int(n_new[slot])
        out = []
        for slot in finishing:
            self._last_tok[slot] = toks[slot]
            out.append((slot, int(toks[slot])))
        return out

    def step(self, active) -> np.ndarray:
        """One decode iteration over the whole slot array: append each
        active slot's last token, attend, sample. Slots with ``active ==
        False`` are frozen. Returns the ``(max_slots,)`` sampled tokens,
        meaningful at active slots only."""
        _STEP_FAULT.fire()
        active = np.asarray(active, np.bool_)
        with torch.no_grad():
            self.cache, toks = self._step_fn(
                self.cache, self._dev(self._last_tok), self._dev(active),
                fold_in(self._seed, self._step_id))
        self._step_id += 1
        toks = toks.cpu().numpy()
        self._last_tok = np.where(active, toks, self._last_tok
                                  ).astype(np.int32)
        return toks

    def spec_step(self, active):
        """One speculative round over the active slots: ``spec_k``
        drafter steps, then one verify pass of the target with rejection
        sampling. Returns ``(out_tokens (S, K), n_emit (S,))``: slot s
        emitted ``out_tokens[s, :n_emit[s]]`` this round (1 to K tokens;
        inactive slots 0). Callers include only slots whose remaining
        budget and context can take K more rows (the batcher gates
        this)."""
        _STEP_FAULT.fire()
        active = np.asarray(active, np.bool_)
        with torch.no_grad():
            t0, act = self._dev(self._last_tok), self._dev(active)
            self._draft_cache, drafts, qprobs = self._draft_fn(
                self._draft_cache, t0, act,
                fold_in(self._seed, self._step_id))
            self._step_id += 1
            (self.cache, self._draft_cache, out, n_acc, n_emit,
             nxt) = self._verify_fn(self.cache, self._draft_cache, t0,
                                    drafts, qprobs, act,
                                    fold_in(self._seed, self._step_id))
            self._step_id += 1
        out, n_acc, n_emit, nxt = (t.cpu().numpy() for t in
                                   (out, n_acc, n_emit, nxt))
        n_emit = np.where(active, n_emit, 0)
        self._last_tok = np.where(active, nxt, self._last_tok
                                  ).astype(np.int32)
        self.spec_proposed += self.spec_k * int(active.sum())
        self.spec_accepted += int(n_acc[active].sum())
        return out, n_emit

    def release(self, slot: int):
        """Retire a slot: reclaim its pages and free it. Its cache rows
        need no reset: a later prefill overwrites ``seq_lens``, and until
        then the ``active`` mask keeps the slot frozen. A slot still
        mid-chunked-prefill has its pending prompt dropped."""
        self._pending_prompts.pop(slot, None)
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self.allocator.free(pages)
        self.free_slots.add(slot)

    # -- prefill/decode handoff -----------------------------------------------
    @property
    def kv_dtype_name(self) -> str:
        """The pools' dtype under numpy's name: float32, bfloat16, int8."""
        return str(self.cache.k_pages.dtype).split(".")[-1]

    def _geometry(self) -> dict:
        kp = self.cache.k_pages
        return {"page_size": self.page_size, "kv_dtype": self.kv_dtype_name,
                "num_layers": int(kp.shape[0]), "heads": int(kp.shape[3]),
                "head_dim": int(kp.shape[4])}

    def export_handoff(self, slot: int) -> dict:
        """Extract an active slot's cache state into a handoff blob and
        retire the slot (its pages return to the pool at once). The blob
        holds the used pages of every block (int8 scales included), the
        position, the last sampled token and the slot's temperature:
        what :meth:`admit_from_handoff` needs to resume decoding with no
        forward pass."""
        if slot in self._pending_prompts:
            raise ValueError(f"slot {slot} is still mid-chunked-prefill")
        if slot in self.free_slots:
            raise ValueError(f"slot {slot} is not active")
        seq_len = int(self.cache.seq_lens[slot])
        if seq_len <= 0:
            raise ValueError(f"slot {slot} has no cached tokens")
        n_used = kvc.PageAllocator.pages_needed(seq_len, self.page_size)
        with torch.no_grad():
            k, v, k_s, v_s = kvc.gather_slot_pages(
                self.cache, self._dev(self._table[slot, :n_used]))
        blob = {"version": kvc.HANDOFF_VERSION, "seq_len": seq_len,
                **self._geometry(),
                "last_token": int(self._last_tok[slot]),
                "temperature": float(self._temps[slot]),
                "k": kvc.rows_to_host(k), "v": kvc.rows_to_host(v),
                "k_scales": None if k_s is None else kvc.rows_to_host(k_s),
                "v_scales": None if v_s is None else kvc.rows_to_host(v_s)}
        self.release(slot)
        return blob

    def _check_handoff_blob(self, blob: dict):
        """Raise ValueError unless this engine can splice ``blob``: its
        version, page geometry, dtype, position and array shapes."""
        if int(blob.get("version", -1)) != kvc.HANDOFF_VERSION:
            raise ValueError(f"handoff version {blob.get('version')!r} != "
                             f"{kvc.HANDOFF_VERSION}")
        mine = self._geometry()
        for key, want in mine.items():
            if blob.get(key) != want:
                raise ValueError(f"handoff {key} mismatch: blob has "
                                 f"{blob.get(key)!r}, engine has {want!r}")
        seq_len = int(blob["seq_len"])
        if not 1 <= seq_len <= self.max_context - 1:
            raise ValueError(f"handoff seq_len {seq_len} outside [1, "
                             f"{self.max_context - 1}]")
        rows = (mine["num_layers"], kvc.PageAllocator.pages_needed(
            seq_len, self.page_size), self.page_size, mine["heads"],
            mine["head_dim"])
        want = {"k": rows, "v": rows}
        if self.cache.k_scales is not None:
            want.update(k_scales=rows[:-1], v_scales=rows[:-1])
        for name, shape in want.items():
            got = None if blob.get(name) is None else np.shape(blob[name])
            if got != shape:
                raise ValueError(f"handoff {name} shape {got}, engine "
                                 f"expects {shape}")

    def admit_from_handoff(self, blob: dict, max_new: int) -> int:
        """Splice a handoff blob into this engine: claim a slot and pages
        (the reservation :meth:`admit` makes, the blob's position standing
        in for the prompt), write the shipped pages into them and restore
        the resume state; no forward pass runs. The next :meth:`step`
        with the slot active appends the blob's ``last_token`` and
        continues the stream token for token. The blob is validated
        before anything is allocated, so a rejected one leaves the engine
        as it was. Returns the slot."""
        self._check_handoff_blob(blob)
        seq_len = int(blob["seq_len"])
        n_used = kvc.PageAllocator.pages_needed(seq_len, self.page_size)
        slot = self._claim(seq_len, max_new, blob["temperature"])
        self._push_table()
        dt = self.cache.k_pages.dtype

        def rows(name, dtype):
            a = blob[name]
            return None if a is None else \
                kvc.rows_from_host(a, dtype, self.device)
        with torch.no_grad():
            self.cache = kvc.scatter_slot_pages(
                self.cache, self._dev(self._table[slot, :n_used]),
                np.ones((n_used,), np.bool_), slot, seq_len,
                rows("k", dt), rows("v", dt),
                rows("k_scales", torch.float32),
                rows("v_scales", torch.float32))
        self._last_tok[slot] = int(blob["last_token"])
        return slot

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
        """JSON-able summary (the reference's keys)."""
        out = {
            "role": self.role,
            "max_slots": self.max_slots,
            "slots_active": self.slots_active,
            "max_context": self.max_context,
            "page_size": self.page_size,
            "free_pages": self.free_pages,
            "total_pages": self.allocator.max_pages,
            "prompt_buckets": list(self.prompt_buckets),
            "warmed_programs": len(self._warmed_programs),
            "kv_dtype": self.kv_dtype_name,
            "prefill_chunk": self.prefill_chunk,
            "spec_k": self.spec_k,
        }
        if self.spec_k > 0:
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
            out["spec_accept_rate"] = (
                self.spec_accepted / self.spec_proposed
                if self.spec_proposed else None)
        return out

    def __repr__(self):
        return (f"GenerationEngine(slots={self.max_slots}, "
                f"context={self.max_context}, "
                f"page_size={self.page_size}, "
                f"free_pages={self.free_pages})")
