"""Transformer layers: MultiHeadAttention, TransformerLayer (GPT-style)
and BERT (port of ``analytics_zoo_tpu/pipeline/api/keras/layers/
transformer.py``; sequence and pipeline parallelism wait).

As in the reference, per-block params are stacked on a leading
``n_block`` axis, so the param trees bridge one to one; the depth loop
is a Python loop over the stacked slices where the reference scans.
Attention is :func:`ops.attention.dot_product_attention`, which
``attention_impl="flash"`` sends to the flash kernels (B7-B10). With
``remat=True`` each block runs under activation checkpointing: the
backward recomputes its activations, so its forward kernel (B8) runs
twice per step. Dropout seeds are derived before each block and the
generators built inside it (``ops/rng.py``), so the recompute draws
the forward's masks again.

The decode surface (``init_kv_cache``, ``prefill``, ``decode_step``,
``forward_chunk``, ``generate``) runs the same ``_split_qkv`` and
``_block_tail`` as the full forward over a paged KV cache
(``ops/kv_cache.py``), whose pools it updates in place. ``decode_step`` attends through
:func:`ops.attention.paged_decode_attention`: on the card at long
contexts the decode kernel (B11) reads each block's pages in place,
else the pages are gathered and attended densely. ``forward_chunk``
(chunked prefill, speculative verify) writes a chunk of C tokens per
slot and attends it densely over the gathered cache
(:func:`ops.attention.chunk_attention`), as the reference does.
``generate``'s loop is a Python loop with the reference's stop rule.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from analytics_zoo_tpu_torch.ops import kv_cache as kvc
from analytics_zoo_tpu_torch.ops.activations import gelu
from analytics_zoo_tpu_torch.ops.attention import (chunk_attention,
                                                   dot_product_attention,
                                                   paged_decode_attention,
                                                   resolve_attention_impl)
from analytics_zoo_tpu_torch.ops.rng import fold_in
from analytics_zoo_tpu_torch.ops.sampling import sample_tokens
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape, ShapeLike, is_multi_shape)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import dropout
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization \
    import layer_norm as _layer_norm


def _normal(generator, shape, stddev):
    return torch.randn(shape, generator=generator) * stddev


def _dropout(x, p, seed, training):
    if not training or p <= 0.0 or seed is None:
        return x
    return dropout(x, p, seed)


def _no_parallel(sequence_parallel_axis=None, pipeline_parallel_axis=None):
    if sequence_parallel_axis or pipeline_parallel_axis:
        raise NotImplementedError(
            "sequence and pipeline parallelism are not ported yet")


class MultiHeadAttention(KerasLayer):
    """Self-attention layer (the per-block attention of the
    TransformerLayer, standalone)."""

    def __init__(self, hidden_size: int, n_head: int,
                 attn_p_drop: float = 0.1, resid_p_drop: float = 0.1,
                 causal: bool = False, initializer_range: float = 0.02,
                 sequence_parallel_axis: Optional[str] = None,
                 attention_impl: Optional[str] = None,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if hidden_size % n_head:
            raise ValueError("hidden_size must divide by n_head")
        _no_parallel(sequence_parallel_axis)
        if attention_impl is not None:
            resolve_attention_impl(attention_impl)  # validate early
        self.attention_impl = attention_impl
        self.hidden_size = int(hidden_size)
        self.n_head = int(n_head)
        self.attn_p_drop = float(attn_p_drop)
        self.resid_p_drop = float(resid_p_drop)
        self.causal = causal
        self.initializer_range = float(initializer_range)

    def build(self, generator, input_shape: Shape) -> dict:
        h, r = self.hidden_size, self.initializer_range
        return {
            "qkv_kernel": _normal(generator, (h, 3 * h), r),
            "qkv_bias": torch.zeros((3 * h,)),
            "out_kernel": _normal(generator, (h, h), r),
            "out_bias": torch.zeros((h,)),
        }

    def call(self, params, x, *, training=False, rng=None, mask=None):
        b, t, h = x.shape
        nh, hd = self.n_head, h // self.n_head
        qkv = x @ params["qkv_kernel"].to(x.dtype) + \
            params["qkv_bias"].to(x.dtype)
        q, k, v = (a.reshape(b, t, nh, hd) for a in qkv.split(h, dim=-1))
        out = dot_product_attention(q, k, v, mask=mask, causal=self.causal,
                                    impl=self.attention_impl)
        out = out.reshape(b, t, h) @ params["out_kernel"].to(x.dtype) + \
            params["out_bias"].to(x.dtype)
        return _dropout(out, self.resid_p_drop, rng, training)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return input_shape


class TransformerLayer(KerasLayer):
    """GPT-style decoder stack.

    Input: (seq_len,) int token ids (positions implicit 0..T-1), or the
    reference's (seq_len, 2) token + position ids. Output: (seq_len,
    hidden_size), or a list of every block's output when
    ``output_all_block``.
    """

    def __init__(self, n_block: int = 12, hidden_size: int = 768,
                 n_head: int = 12, seq_len: int = 512,
                 vocab: int = 40990, intermediate_size: int = 0,
                 hidden_p_drop: float = 0.1, attn_p_drop: float = 0.1,
                 initializer_range: float = 0.02,
                 bidirectional: bool = False,
                 output_all_block: bool = False,
                 embed_p_drop: float = 0.1,
                 sequence_parallel_axis: Optional[str] = None,
                 attention_impl: Optional[str] = None,
                 remat: bool = False,
                 pipeline_parallel_axis: Optional[str] = None,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape or (seq_len,),
                         name=name, **kwargs)
        if hidden_size % n_head:
            raise ValueError("hidden_size must divide by n_head")
        _no_parallel(sequence_parallel_axis, pipeline_parallel_axis)
        if attention_impl is not None:
            resolve_attention_impl(attention_impl)  # validate early
        self.attention_impl = attention_impl
        self.remat = bool(remat)
        self.n_block = int(n_block)
        self.hidden_size = int(hidden_size)
        self.n_head = int(n_head)
        self.seq_len = int(seq_len)
        self.vocab = int(vocab)
        self.intermediate_size = int(intermediate_size) or \
            4 * self.hidden_size
        self.hidden_p_drop = float(hidden_p_drop)
        # stored, never applied: the reference applies no attention
        # dropout either
        self.attn_p_drop = float(attn_p_drop)
        self.initializer_range = float(initializer_range)
        self.bidirectional = bidirectional
        self.output_all_block = output_all_block
        self.embed_p_drop = float(embed_p_drop)

    # -- params -------------------------------------------------------------
    def _build_blocks(self, generator) -> dict:
        """Per-block params stacked on a leading n_block axis."""
        h, m, n = self.hidden_size, self.intermediate_size, self.n_block
        r = self.initializer_range
        return {
            "qkv_kernel": _normal(generator, (n, h, 3 * h), r),
            "qkv_bias": torch.zeros((n, 3 * h)),
            "attn_out_kernel": _normal(generator, (n, h, h), r),
            "attn_out_bias": torch.zeros((n, h)),
            "ln1_g": torch.ones((n, h)),
            "ln1_b": torch.zeros((n, h)),
            "mlp_in_kernel": _normal(generator, (n, h, m), r),
            "mlp_in_bias": torch.zeros((n, m)),
            "mlp_out_kernel": _normal(generator, (n, m, h), r),
            "mlp_out_bias": torch.zeros((n, h)),
            "ln2_g": torch.ones((n, h)),
            "ln2_b": torch.zeros((n, h)),
        }

    def build(self, generator, input_shape: ShapeLike) -> dict:
        r = self.initializer_range
        return {
            "tok_embed": _normal(generator, (self.vocab, self.hidden_size),
                                 r),
            "pos_embed": _normal(generator,
                                 (self.seq_len, self.hidden_size), r),
            "blocks": self._build_blocks(generator),
        }

    # -- forward ------------------------------------------------------------
    def _split_qkv(self, p, x):
        """(..., H) → q, k, v with heads split: column slices of one
        projection, which the flash kernels read in place."""
        nh = self.n_head
        hd = self.hidden_size // nh
        qkv = x @ p["qkv_kernel"].to(x.dtype) + p["qkv_bias"].to(x.dtype)
        shp = x.shape[:-1] + (nh, hd)
        return tuple(a.reshape(shp)
                     for a in qkv.split(self.hidden_size, dim=-1))

    def _block_tail(self, p, x, attn, r1=None, r2=None, training=False):
        """Out-projection + residual/LN + MLP half of a block."""
        attn = attn @ p["attn_out_kernel"].to(x.dtype) + \
            p["attn_out_bias"].to(x.dtype)
        attn = _dropout(attn, self.hidden_p_drop, r1, training)
        x = _layer_norm(x + attn, p["ln1_g"], p["ln1_b"])
        mlp = gelu(x @ p["mlp_in_kernel"].to(x.dtype) +
                   p["mlp_in_bias"].to(x.dtype))
        mlp = mlp @ p["mlp_out_kernel"].to(x.dtype) + \
            p["mlp_out_bias"].to(x.dtype)
        mlp = _dropout(mlp, self.hidden_p_drop, r2, training)
        return _layer_norm(x + mlp, p["ln2_g"], p["ln2_b"])

    def _embed(self, params, x):
        if x.dim() == 3:  # reference layout (B, T, 2): token + position
            tok_ids = x[..., 0].long()
            pos = F.embedding(x[..., 1].long(), params["pos_embed"])
        else:
            tok_ids = x.long()
            pos = params["pos_embed"][None, :tok_ids.shape[1]]
        return F.embedding(tok_ids, params["tok_embed"]) + pos

    def _block(self, x, p, seed, mask, training):
        b, t, hsz = x.shape
        r1 = r2 = None
        if seed is not None:
            r1, r2 = fold_in(seed, 1), fold_in(seed, 2)
        q, k, v = self._split_qkv(p, x)
        attn = dot_product_attention(q, k, v, mask=mask,
                                     causal=not self.bidirectional,
                                     impl=self.attention_impl)
        return self._block_tail(p, x, attn.reshape(b, t, hsz), r1, r2,
                                training)

    def _run_blocks(self, params, h0, mask, training, rng):
        """Every block in order; returns (final, [each block's output]
        when ``output_all_block``)."""
        x, outs = h0, []
        for i in range(self.n_block):
            p = self._block_params(params, i)
            seed = None if rng is None else fold_in(rng, i)
            if self.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    self._block, x, p, seed, mask, training,
                    use_reentrant=False)
            else:
                x = self._block(x, p, seed, mask, training)
            if self.output_all_block:
                outs.append(x)
        return x, outs

    def call(self, params, x, *, training=False, rng=None, mask=None):
        r_embed = None
        if rng is not None:
            rng, r_embed = fold_in(rng, 0), fold_in(rng, 1)
        h0 = _dropout(self._embed(params, x), self.embed_p_drop, r_embed,
                      training)
        final, all_blocks = self._run_blocks(params, h0, mask, training,
                                             rng)
        return all_blocks if self.output_all_block else final

    def compute_output_shape(self, input_shape: ShapeLike):
        t = (input_shape[0][0] if is_multi_shape(input_shape)
             else input_shape[0])
        shape = (t, self.hidden_size)
        if self.output_all_block:
            return [shape] * self.n_block
        return shape

    # -- decode path --------------------------------------------------------
    # ``prefill`` runs the prompts once and caches every block's K/V;
    # ``decode_step`` extends every slot by one token against the cache,
    # ``forward_chunk`` by up to C tokens; ``generate`` loops the first
    # two. Logits are tied to ``tok_embed``. Int8
    # caches carry scale pools that this layer only threads through.
    # Inference only: no dropout.

    def init_kv_cache(self, max_slots: int, max_context: int,
                      page_size: int = 16, dtype=None, device=None
                      ) -> kvc.PagedKVCache:
        """A fresh paged cache for this stack: one pool per block, the
        identity page table, on ``device`` (default: the context's)."""
        if device is None:
            from analytics_zoo_tpu_torch.common.nncontext import \
                get_nncontext
            device = get_nncontext().device
        return kvc.init_cache(
            self.n_block, int(max_slots), int(max_context), self.n_head,
            self.hidden_size // self.n_head, page_size=int(page_size),
            dtype=dtype or torch.float32, device=device)

    @staticmethod
    def _block_params(params, i: int) -> dict:
        return {k: v[i] for k, v in params["blocks"].items()}

    def prefill(self, params, cache: kvc.PagedKVCache, token_ids,
                prompt_lens):
        """Run the (right-padded) prompts once, write every block's K/V
        into the cache and return ``(cache', logits (S, V))``, the logits
        at each slot's last prompt position.

        token_ids: (S, T) int; prompt_lens: (S,) int. Slots with
        ``prompt_lens == 0`` are untouched, which lets the batcher admit
        into a live batch. Pad positions sit after every real token, so
        causality keeps them out of the real rows, and their K/V are
        never written."""
        dev = cache.seq_lens.device
        token_ids = torch.as_tensor(token_ids, device=dev)
        prompt_lens = torch.as_tensor(prompt_lens, dtype=torch.int32,
                                      device=dev)
        s, t = token_ids.shape
        x = self._embed(params, token_ids)
        ks, vs = [], []
        for i in range(self.n_block):
            p = self._block_params(params, i)
            q, k, v = self._split_qkv(p, x)
            attn = dot_product_attention(q, k, v,
                                         causal=not self.bidirectional,
                                         impl=self.attention_impl)
            x = self._block_tail(p, x, attn.reshape(s, t, self.hidden_size))
            ks.append(k)
            vs.append(v)
        cache = self._write_prompt_all(cache, ks, vs, prompt_lens)
        cache = cache._replace(seq_lens=torch.where(
            prompt_lens > 0, prompt_lens, cache.seq_lens))
        last = x[torch.arange(s, device=dev),
                 (prompt_lens - 1).clamp_min(0).long()]
        return cache, last @ params["tok_embed"].to(last.dtype).T

    def _write_prompt_all(self, cache, k_all, v_all, total_lens,
                          start=None):
        """Write each block's prompt K/V (``k_all``/``v_all``: one
        (S, T, nh, hd) tensor per block) into its pool, in place,
        through coordinates computed once; quantized caches write their
        scale pools through the same ones. ``seq_lens`` is the
        caller's to update."""
        coords = kvc.prompt_coords(cache.page_table, total_lens,
                                   k_all[0].shape[1], cache.page_size,
                                   start)
        for i, (k, v) in enumerate(zip(k_all, v_all)):
            kvc.write_prompt_layer(
                cache.k_pages[i], cache.v_pages[i], cache.page_table,
                total_lens, k, v, start=start,
                k_scales=None if cache.k_scales is None else
                cache.k_scales[i],
                v_scales=None if cache.v_scales is None else
                cache.v_scales[i], coords=coords)
        return cache

    def decode_step(self, params, cache: kvc.PagedKVCache, token_ids,
                    active=None):
        """One decode step for every slot: consume ``token_ids`` (S,),
        each slot's previously sampled token, at position
        ``cache.seq_lens[s]``, append its K/V, attend over the cache and
        return ``(cache', logits (S, V))``. Slots with ``active ==
        False`` are frozen: nothing is written and their length does not
        advance."""
        dev = cache.seq_lens.device
        token_ids = torch.as_tensor(token_ids, device=dev)
        s = token_ids.shape[0]
        seq_lens = cache.seq_lens
        active = seq_lens > 0 if active is None else \
            torch.as_tensor(active, dtype=torch.bool, device=dev)
        pos = seq_lens.clamp(0, self.seq_len - 1).long()
        x = F.embedding(token_ids.long(), params["tok_embed"]) + \
            F.embedding(pos, params["pos_embed"])
        table = cache.page_table
        lens_after = seq_lens + active.to(torch.int32)
        coords = kvc.append_coords(table, seq_lens, cache.page_size, active)
        for i in range(self.n_block):
            p = self._block_params(params, i)
            kp, vp = cache.k_pages[i], cache.v_pages[i]
            ks = None if cache.k_scales is None else cache.k_scales[i]
            vs = None if cache.v_scales is None else cache.v_scales[i]
            q, k_new, v_new = self._split_qkv(p, x)
            kvc.append_layer(kp, vp, table, seq_lens, k_new, v_new,
                             active=active, k_scales=ks, v_scales=vs,
                             coords=coords)
            attn = paged_decode_attention(q, kp, vp, table, lens_after,
                                          impl=self.attention_impl,
                                          k_scales=ks, v_scales=vs)
            x = self._block_tail(p, x, attn.reshape(s, self.hidden_size))
        cache = cache._replace(seq_lens=lens_after)
        return cache, x @ params["tok_embed"].to(x.dtype).T

    def forward_chunk(self, params, cache: kvc.PagedKVCache, token_ids,
                      starts, n_new, all_logits: bool = False):
        """Consume a chunk of new tokens per slot against the cache:
        ``decode_step`` from 1 to C tokens, with a per-slot offset.

        token_ids: (S, C) int, each slot's next tokens, left-aligned and
        right-padded; starts: (S,) the absolute position the chunk
        begins at (the slot's cached length); n_new: (S,) how many of
        the C rows are real (0: the slot is untouched, nothing written,
        its length frozen). Each block writes the chunk's K/V into the
        pages first, then attends over the gathered cache with the mask
        ``key_pos <= start + j`` (:func:`ops.attention.chunk_attention`).

        Returns ``(cache', logits)``: (S, V) at each slot's last real
        row (chunked prefill samples the first token from it), or (S, C,
        V) at every row when ``all_logits`` (speculative verify).
        ``seq_lens`` becomes ``starts + n_new`` where ``n_new > 0``."""
        dev = cache.seq_lens.device
        token_ids = torch.as_tensor(token_ids, device=dev)
        starts = torch.as_tensor(starts, dtype=torch.int32, device=dev)
        n_new = torch.as_tensor(n_new, dtype=torch.int32, device=dev)
        s, c = token_ids.shape
        total = starts + n_new
        q_pos = starts[:, None] + torch.arange(c, dtype=torch.int32,
                                               device=dev)[None]
        x = F.embedding(token_ids.long(), params["tok_embed"]) + \
            F.embedding(q_pos.clamp(0, self.seq_len - 1).long(),
                        params["pos_embed"])
        table = cache.page_table
        t_max = cache.max_context
        coords = kvc.prompt_coords(table, total, c, cache.page_size, starts)
        for i in range(self.n_block):
            p = self._block_params(params, i)
            kp, vp = cache.k_pages[i], cache.v_pages[i]
            ks = None if cache.k_scales is None else cache.k_scales[i]
            vs = None if cache.v_scales is None else cache.v_scales[i]
            q, k_new, v_new = self._split_qkv(p, x)
            kvc.write_prompt_layer(kp, vp, table, total, k_new, v_new,
                                   start=starts, k_scales=ks, v_scales=vs,
                                   coords=coords)
            k_ctx, v_ctx, sk, sv = kvc.gather_context(
                kp, vp, table, t_max, x.dtype, ks, vs)
            attn = chunk_attention(q, k_ctx, v_ctx, q_pos, k_scales=sk,
                                   v_scales=sv)
            x = self._block_tail(p, x, attn.reshape(s, c, self.hidden_size))
        cache = cache._replace(seq_lens=torch.where(n_new > 0, total,
                                                    cache.seq_lens))
        embed_t = params["tok_embed"].to(x.dtype).T
        if all_logits:
            return cache, x @ embed_t
        last = x[torch.arange(s, device=dev),
                 (n_new - 1).clamp(0, c - 1).long()]
        return cache, last @ embed_t

    def generate(self, params, prompts, prompt_lens=None,
                 max_new_tokens: int = 32, *, temperature=0.0,
                 top_k: int = 0, eos_id=None, rng=None,
                 page_size: int = 16, cache_dtype=None):
        """Autoregressive generation: prefill, then decode steps until
        ``max_new_tokens`` or every slot has emitted ``eos_id``. Greedy
        where ``temperature <= 0`` (a scalar or (S,)), else sampling
        with optional ``top_k``; ``rng`` is an int seed (default 0),
        step i drawing with ``fold_in(rng, i)``.

        prompts: (S, T) int, right-padded to ``prompt_lens``. Returns
        ``(tokens (S, T + max_new_tokens), lengths (S,))``: per slot,
        ``tokens[s, :lengths[s]]`` is prompt + generation, on the
        params' device."""
        dev = params["tok_embed"].device
        prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
        s, tp = prompts.shape
        prompt_lens = torch.full((s,), tp, dtype=torch.int32, device=dev) \
            if prompt_lens is None else torch.as_tensor(
                prompt_lens, dtype=torch.int32, device=dev)
        seed = 0 if rng is None else int(rng)
        max_new = int(max_new_tokens)
        total = tp + max_new
        temp = temperature if isinstance(temperature, torch.Tensor) else \
            np.array(np.broadcast_to(np.asarray(temperature, np.float32),
                                     (s,)))
        cache = self.init_kv_cache(s, total, page_size=page_size,
                                   dtype=cache_dtype, device=dev)
        cache, logits = self.prefill(params, cache, prompts, prompt_lens)
        rows = torch.arange(s, device=dev)
        buf = torch.zeros((s, total), dtype=torch.int32, device=dev)
        buf[:, :tp] = prompts
        tok = sample_tokens(fold_in(seed, 0), logits, temp, top_k)
        buf[rows, prompt_lens.long()] = tok
        done = tok == eos_id if eos_id is not None else \
            torch.zeros((s,), dtype=torch.bool, device=dev)
        n_new = torch.ones((s,), dtype=torch.int32, device=dev)
        i = 1
        while i < max_new and not bool(done.all()):
            active = ~done
            cache, logits = self.decode_step(params, cache, tok,
                                             active=active)
            nxt = sample_tokens(fold_in(seed, i), logits, temp, top_k)
            pos = (prompt_lens + i).clamp(0, total - 1).long()
            buf[rows, pos] = torch.where(active, nxt, buf[rows, pos])
            n_new = n_new + active.to(torch.int32)
            if eos_id is not None:
                done = done | (active & (nxt == eos_id))
            tok = torch.where(active, nxt, tok)
            i += 1
        return buf, prompt_lens + n_new


class BERT(TransformerLayer):
    """BERT encoder.

    Inputs: a list of 4 tensors, ``[token_ids (B, T), token_type_ids
    (B, T), position_ids (B, T), attention_mask (B, T)]``. Output:
    ``[sequence_output(s), pooled_output]``: every block's sequence
    output when ``output_all_block``, else the last block's, then the
    tanh-Dense pooled first token.
    """

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 3072,
                 hidden_p_drop: float = 0.1, attn_p_drop: float = 0.1,
                 initializer_range: float = 0.02,
                 output_all_block: bool = True,
                 n_token_types: int = 2,
                 sequence_parallel_axis: Optional[str] = None,
                 input_shape=None, name=None, **kwargs):
        super().__init__(
            n_block=n_block, hidden_size=hidden_size, n_head=n_head,
            seq_len=seq_len, vocab=vocab,
            intermediate_size=intermediate_size,
            hidden_p_drop=hidden_p_drop, attn_p_drop=attn_p_drop,
            initializer_range=initializer_range, bidirectional=True,
            output_all_block=output_all_block,
            sequence_parallel_axis=sequence_parallel_axis,
            input_shape=input_shape or [(seq_len,)] * 4,
            name=name, **kwargs)
        self.n_token_types = int(n_token_types)

    def build(self, generator, input_shape: ShapeLike) -> dict:
        params = super().build(generator, input_shape)
        h, r = self.hidden_size, self.initializer_range
        params["type_embed"] = _normal(generator, (self.n_token_types, h), r)
        params["embed_ln_g"] = torch.ones((h,))
        params["embed_ln_b"] = torch.zeros((h,))
        params["pooler_kernel"] = _normal(generator, (h, h), r)
        params["pooler_bias"] = torch.zeros((h,))
        return params

    def call(self, params, inputs, *, training=False, rng=None):
        token_ids, token_type_ids, position_ids, attn_mask = inputs
        h0 = (F.embedding(token_ids.long(), params["tok_embed"]) +
              F.embedding(position_ids.long(), params["pos_embed"]) +
              F.embedding(token_type_ids.long(), params["type_embed"]))
        h0 = _layer_norm(h0, params["embed_ln_g"], params["embed_ln_b"])
        r_embed = None
        if rng is not None:
            rng, r_embed = fold_in(rng, 0), fold_in(rng, 1)
        h0 = _dropout(h0, self.embed_p_drop, r_embed, training)
        # (B, 1, 1, T) key-padding mask: the kernels' native form
        mask = attn_mask[:, None, None, :]
        final, all_blocks = self._run_blocks(params, h0, mask, training,
                                             rng)
        pooled = torch.tanh(
            final[:, 0] @ params["pooler_kernel"].to(final.dtype) +
            params["pooler_bias"].to(final.dtype))
        return (all_blocks if self.output_all_block else [final]) + \
            [pooled]

    def compute_output_shape(self, input_shape: ShapeLike):
        t = input_shape[0][0]
        seq_shape = (t, self.hidden_size)
        n = self.n_block if self.output_all_block else 1
        return [seq_shape] * n + [(self.hidden_size,)]
