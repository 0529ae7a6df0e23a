"""The PyTorch port's generation levers against the JAX package's:
chunked prefill (``chunk_attention``, ``forward_chunk``,
``admit_partial``/``prefill_step``), speculative decoding
(``speculative_accept``, ``spec_step``, the batcher's spec branch), the
prefill/decode KV handoff (``gather_slot_pages``/``scatter_slot_pages``,
the wire codec, ``export_handoff``/``admit_from_handoff``,
``submit_prefill``/``submit_handoff``) and the fault points they need
(``common/faults.py``).

The toy stack of ``tests/test_torch_generate.py`` (2 blocks, hidden 32,
2 heads, seq_len 32, vocab 61) and a one-block drafter (hidden 16),
their JAX weights bridged into the port. Tolerances, as a fraction of
max(1, |ref|): 1e-5 for f32, 2e-2 for a bf16 cache, 5e-2 for an int8
one. Greedy streams must equal the JAX engine's; handoff pages and the
wire codec are compared bit for bit.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.ops import attention as jatt
from analytics_zoo_tpu.ops import kv_cache as jkvc
from analytics_zoo_tpu.ops import sampling as jsamp
from analytics_zoo_tpu.pipeline.api.keras.layers import transformer as jtr
from analytics_zoo_tpu.pipeline.inference.generation import \
    GenerationEngine as JEngine
from analytics_zoo_tpu_torch.bridge import (kv_cache_from_numpy,
                                            kv_cache_to_numpy)
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common.faults import (InjectedFaultError,
                                                   InjectedKillError)
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import kv_cache as tkvc
from analytics_zoo_tpu_torch.ops import sampling as tsamp
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    transformer as ttr
from analytics_zoo_tpu_torch.pipeline.inference import (
    ContinuousBatcher, DynamicBatcher, GenerationEngine, InferenceModel)

SEQ, VOCAB = 32, 61
TOY = dict(n_block=2, hidden_size=32, n_head=2, vocab=VOCAB, seq_len=SEQ,
           hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
DRAFT = dict(TOY, n_block=1, hidden_size=16)
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
KV = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    faults.reset_faults()
    yield
    faults.reset_faults()
    tobs.reset_metrics()
    tzoo.reset_nncontext()


_NETS = {}


def _nets():
    """(JAX target, its host params, port target, JAX drafter, its host
    params, port drafter), built once."""
    if not _NETS:
        jnet = jtr.TransformerLayer(**TOY)
        jd = jtr.TransformerLayer(**DRAFT)
        _NETS["v"] = (
            jnet, jax.device_get(jnet.build(jax.random.key(0), (SEQ,))),
            ttr.TransformerLayer(**TOY), jd,
            jax.device_get(jd.build(jax.random.key(7), (SEQ,))),
            ttr.TransformerLayer(**DRAFT))
    return _NETS["v"]


def _engine(side="torch", drafter=False, self_draft=False, **kw):
    jnet, params, tnet, jd, dparams, td = _nets()
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_context", SEQ)
    kw.setdefault("page_size", 8)
    if side == "jax":
        params = jax.tree_util.tree_map(jnp.asarray, params)
        dparams = jax.tree_util.tree_map(jnp.asarray, dparams)
    net, dnet = (jnet, jd) if side == "jax" else (tnet, td)
    if self_draft:
        kw.update(drafter=net, drafter_params=params)
    elif drafter:
        kw.update(drafter=dnet, drafter_params=dparams)
    return (JEngine if side == "jax" else GenerationEngine)(net, params,
                                                             **kw)


_REFS = {}


def _ref(prompt, max_new, eos_id=None):
    """The JAX engine's greedy stream (whole-prompt, no lever)."""
    key = (tuple(prompt), max_new, eos_id)
    if key not in _REFS:
        if "eng" not in _REFS:
            _REFS["eng"] = _engine("jax")
        _REFS[key] = [int(t) for t in _REFS["eng"].generate(
            list(prompt), max_new_tokens=max_new, eos_id=eos_id)[0]]
    return _REFS[key]


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _jax_cache(jnet, slots, dtype, rs):
    """A JAX cache with random stale rows and a permuted page table."""
    c = jax.device_get(jnet.init_kv_cache(slots, SEQ, page_size=8,
                                          dtype=JDT[dtype]))
    table = rs.permutation(c.k_pages.shape[1]).astype(np.int32).reshape(
        c.page_table.shape)
    stale = rs.randn(*c.k_pages.shape) * (60 if dtype == "int8" else 1)
    c = c._replace(k_pages=stale.astype(c.k_pages.dtype),
                   v_pages=(-stale).astype(c.v_pages.dtype),
                   page_table=table)
    if dtype == "int8":
        sc = rs.uniform(0.01, 0.1, size=c.k_scales.shape)
        c = c._replace(k_scales=sc.astype(np.float32),
                       v_scales=(sc * 2).astype(np.float32))
    return c


def _drive(eng, slot, first, prompt_len, max_new):
    """Finish one admitted request by hand: speculative rounds while the
    k-token window fits the reservation, plain steps for the tail (the
    batcher's gate, inlined)."""
    got = [first]
    active = np.zeros((eng.max_slots,), np.bool_)
    active[slot] = True
    while len(got) < max_new:
        window = prompt_len + len(got) - 1 + eng.spec_k
        if eng.spec_k > 0 and window <= min(prompt_len + max_new,
                                            eng.max_context):
            out, n_emit = eng.spec_step(active)
            got.extend(int(t) for t in out[slot, :n_emit[slot]])
        else:
            got.append(int(eng.step(active)[slot]))
    return got[:max_new]


def _metric(name):
    fam = tobs.snapshot().get(name)
    return 0.0 if fam is None else sum(v["value"] for v in fam["values"])


# -- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chunk_attention_matches_jax(dtype):
    """C queries per slot at their absolute positions over a gathered
    view: f32, bf16 pages (as the engine hands them over, converted to
    f32) and int8 pages with their scales."""
    rs = np.random.RandomState(0)
    s, c, t, h, d = 3, 5, 32, 2, 16
    q = rs.randn(s, c, h, d).astype(np.float32)
    kv = [rs.randn(s, t, h, d).astype(np.float32) for _ in range(2)]
    pos = (np.asarray([0, 7, 20])[:, None] + np.arange(c)).astype(np.int32)
    scales = [None, None]
    if dtype == "bfloat16":
        kv = [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
              for x in kv]
    if dtype == "int8":
        kv = [(x * 40).astype(np.int8) for x in kv]
        scales = [rs.uniform(0.01, 0.05, (s, t, h)).astype(np.float32)
                  for _ in range(2)]
    want = jatt.chunk_attention(
        jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        jnp.asarray(pos), k_scales=None if scales[0] is None else
        jnp.asarray(scales[0]), v_scales=None if scales[1] is None else
        jnp.asarray(scales[1]))
    got = tatt.chunk_attention(
        torch.from_numpy(q), torch.from_numpy(kv[0]),
        torch.from_numpy(kv[1]), torch.from_numpy(pos),
        k_scales=None if scales[0] is None else torch.from_numpy(scales[0]),
        v_scales=None if scales[1] is None else torch.from_numpy(scales[1]))
    _close(got, want, 1e-5, dtype)


@pytest.mark.parametrize("all_logits", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_forward_chunk_matches_jax(dtype, all_logits):
    """A chunk over a cache of stale rows and a permuted table, slot 1
    passing n_new = 0: logits, the written cache, and slot 1's pages
    and length bit for bit as they were."""
    jnet, params, tnet, *_ = _nets()
    rs = np.random.RandomState(1)
    jc = _jax_cache(jnet, 3, dtype, rs)
    jc = jc._replace(seq_lens=np.asarray([5, 11, 9], np.int32))
    ids = rs.randint(1, VOCAB, size=(3, 6)).astype(np.int32)
    starts = np.asarray([5, 11, 9], np.int32)
    n_new = np.asarray([6, 0, 2], np.int32)
    jout, jlg = jnet.forward_chunk(
        params, jax.tree_util.tree_map(jnp.asarray, jc), jnp.asarray(ids),
        jnp.asarray(starts), jnp.asarray(n_new), all_logits=all_logits)
    cache = kv_cache_from_numpy(jc)
    frozen = cache.clone()
    tout, tlg = tnet.forward_chunk(_tparams(params), cache,
                                   torch.from_numpy(ids),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(n_new),
                                   all_logits=all_logits)
    rows = [0, 2]
    _close(tlg[rows], np.asarray(jlg)[rows], TOL[dtype], "logits")
    got, want = kv_cache_to_numpy(tout), jax.device_get(jout)
    np.testing.assert_array_equal(got["seq_lens"], want.seq_lens)
    assert got["seq_lens"].tolist() == [11, 11, 11]
    for f in ("k_pages", "v_pages", "k_scales", "v_scales"):
        if getattr(want, f) is not None:
            _close(got[f], np.asarray(getattr(want, f), np.float32),
                   TOL[dtype], f)
    pages = torch.from_numpy(jc.page_table[1]).long()
    for f in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(tout, f), getattr(frozen, f)
        if a is not None:
            assert torch.equal(a[:, pages], b[:, pages]), f


def _tparams(params):
    from analytics_zoo_tpu_torch.bridge import params_from_numpy
    return params_from_numpy(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gather_and_scatter_slot_pages_bit_exact(dtype):
    jnet, *_ = _nets()
    rs = np.random.RandomState(2)
    src, dst = (_jax_cache(jnet, 4, dtype, rs) for _ in range(2))
    ids = src.page_table[2]
    jrows = jkvc.gather_slot_pages(jax.tree_util.tree_map(jnp.asarray, src),
                                   jnp.asarray(ids))
    trows = tkvc.gather_slot_pages(kv_cache_from_numpy(src),
                                   torch.from_numpy(ids))
    for a, b in zip(trows, jrows):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(tkvc.rows_to_host(a).view(
                np.asarray(b).dtype), np.asarray(b))
    active = np.arange(len(ids)) < 3
    dids = dst.page_table[1]
    jout = jkvc.scatter_slot_pages(
        jax.tree_util.tree_map(jnp.asarray, dst), jnp.asarray(dids),
        jnp.asarray(active), 1, 21, *jrows)
    tout = tkvc.scatter_slot_pages(kv_cache_from_numpy(dst),
                                   torch.from_numpy(dids), active, 1, 21,
                                   *trows)
    got, want = kv_cache_to_numpy(tout), jax.device_get(jout)
    for f in ("k_pages", "v_pages", "k_scales", "v_scales", "seq_lens"):
        if getattr(want, f) is None:
            assert got[f] is None
        else:
            w = np.asarray(getattr(want, f))
            np.testing.assert_array_equal(np.asarray(got[f]).astype(
                np.float64), w.astype(np.float64), err_msg=f)


def test_speculative_accept_greedy_matches_jax():
    """One-hot p and q (greedy target and drafter): n_accept and the
    corrected token equal the reference's, whatever the draws."""
    rs = np.random.RandomState(3)
    s, k, v = 16, 4, 9
    tgt = rs.randint(0, v, size=(s, k))
    drafts = np.where(rs.rand(s, k) < 0.6, tgt, rs.randint(0, v, (s, k)))
    p = np.eye(v, dtype=np.float32)[tgt]
    q = np.eye(v, dtype=np.float32)[drafts]
    jn, jc = jsamp.speculative_accept(jax.random.key(0), jnp.asarray(p),
                                      jnp.asarray(q),
                                      jnp.asarray(drafts, jnp.int32))
    tn, tc = tsamp.speculative_accept(5, torch.from_numpy(p),
                                      torch.from_numpy(q),
                                      torch.from_numpy(drafts))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    full = tn.numpy() < k
    np.testing.assert_array_equal(tc.numpy()[full], np.asarray(jc)[full])
    assert tn.dtype == tc.dtype == torch.int32


def test_speculative_accept_matches_target_distribution():
    """Over 20k k=1 rounds with mismatched draft and target laws, the
    emitted token's law is the target's (total variation <= 0.025)."""
    rs = np.random.RandomState(6)
    v, n = 5, 20000
    p = rs.dirichlet(np.ones(v)).astype(np.float32)
    q = rs.dirichlet(np.ones(v)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    drafts = torch.multinomial(torch.from_numpy(q), n, replacement=True,
                               generator=g)[:, None]
    pb = torch.from_numpy(p).expand(n, 1, v)
    qb = torch.from_numpy(q).expand(n, 1, v)
    n_acc, corrected = tsamp.speculative_accept(11, pb, qb, drafts)
    emitted = torch.where(n_acc >= 1, drafts[:, 0].int(), corrected)
    hist = np.bincount(emitted.numpy(), minlength=v) / n
    assert 0.5 * np.abs(hist - p).sum() <= 0.025, (hist, p)
    again = tsamp.speculative_accept(11, pb, qb, drafts)
    assert torch.equal(again[0], n_acc) and torch.equal(again[1], corrected)


# -- chunked prefill ----------------------------------------------------------

def test_chunked_prefill_engine_exact_and_cancel_reclaims():
    eng = _engine(prefill_chunk=4)
    rs = np.random.RandomState(8)
    prompt = rs.randint(1, VOCAB, size=11).tolist()    # 3 chunks
    other = rs.randint(1, VOCAB, size=6).tolist()      # 2 chunks
    total = eng.allocator.max_pages
    s0, s1 = eng.admit_partial([(prompt, 5, 0.0), (other, 4, 0.0)])
    assert eng.prefilling_slots == {s0, s1}
    assert eng.prefill_step() == []
    free_before = eng.free_pages
    eng.release(s1)                    # cancelled mid-prefill
    assert s1 not in eng.prefilling_slots
    assert eng.free_pages > free_before
    out = {}
    while eng.prefilling_slots:
        out.update(eng.prefill_step())
    got = [out[s0]]
    active = np.zeros((eng.max_slots,), np.bool_)
    active[s0] = True
    while len(got) < 5:
        got.append(int(eng.step(active)[s0]))
    eng.release(s0)
    assert got == _ref(prompt, 5)
    assert eng.free_pages == total and eng.slots_active == 0
    with pytest.raises(ValueError):
        _engine().admit_partial([(prompt, 5, 0.0)])


def test_forward_chunk_last_row_matches_uncached_forward():
    """A prompt fed in 4-token chunks: the last chunk's logits equal the
    uncached forward's at the last position (f32, 1e-5)."""
    _, params, tnet, *_ = _nets()
    tp = _tparams(params)
    rs = np.random.RandomState(9)
    prompt = rs.randint(1, VOCAB, size=(1, 14)).astype(np.int32)
    cache = tnet.init_kv_cache(1, SEQ, page_size=8, device="cpu")
    for off in range(0, 14, 4):
        n = min(4, 14 - off)
        ids = np.zeros((1, 4), np.int32)
        ids[0, :n] = prompt[0, off:off + n]
        cache, lg = tnet.forward_chunk(tp, cache, ids, [off], [n])
    full = tnet.call(tp, torch.from_numpy(prompt))[0, -1] @ \
        tp["tok_embed"].T
    _close(lg[0], full, 1e-5)
    assert cache.seq_lens.tolist() == [14]


def test_chunked_prefill_batcher_exact_with_staggered_admission():
    eng = _engine(max_slots=2, prefill_chunk=4)
    rs = np.random.RandomState(9)
    jobs = [(rs.randint(1, VOCAB, size=n).tolist(), m)
            for n, m in [(11, 6), (14, 4), (3, 8), (9, 5), (7, 7)]]
    cb = ContinuousBatcher(eng, queue_depth=16).start()
    try:
        futs = []
        for i, (p, m) in enumerate(jobs):
            futs.append(cb.submit(p, max_new_tokens=m))
            if i < 2:
                time.sleep(0.01)
        outs = [[int(t) for t in f.result(timeout=60)] for f in futs]
    finally:
        cb.stop()
    assert outs == [_ref(p, m) for p, m in jobs]
    assert eng.slots_active == 0
    assert eng.free_pages == eng.allocator.max_pages
    assert _metric("zoo_tpu_serving_gen_prefill_chunks_total") >= 3
    assert tobs.snapshot()["zoo_tpu_decode_prefill_chunk_seconds"][
        "values"][0]["count"] >= 3
    assert eng.stats()["prefill_chunk"] == 4


# -- speculative decoding -----------------------------------------------------

def test_speculative_engine_greedy_exact_with_rejections():
    eng = _engine(spec_k=3, drafter=True)
    rs = np.random.RandomState(10)
    for plen, max_new in [(3, 9), (7, 6)]:
        prompt = rs.randint(1, VOCAB, size=plen).tolist()
        (slot, first), = eng.admit([(prompt, max_new, 0.0)])
        assert _drive(eng, slot, first, plen, max_new) == \
            _ref(prompt, max_new)
        eng.release(slot)
    assert 0 <= eng.spec_accepted < eng.spec_proposed   # rejections seen
    st = eng.stats()
    assert st["spec_k"] == 3
    assert st["spec_accept_rate"] == eng.spec_accepted / eng.spec_proposed
    assert set(st) == set(_engine("jax", spec_k=3, drafter=True).stats())


def test_speculative_self_draft_accepts_everything():
    eng = _engine(spec_k=2, self_draft=True)
    prompt = [4, 19, 7]
    (slot, first), = eng.admit([(prompt, 8, 0.0)])
    assert _drive(eng, slot, first, 3, 8) == _ref(prompt, 8)
    assert eng.spec_proposed > 0
    assert eng.spec_accepted == eng.spec_proposed


def test_speculative_batcher_greedy_exact_and_stats():
    eng = _engine(max_slots=2, spec_k=2, drafter=True)
    rs = np.random.RandomState(12)
    jobs = [(rs.randint(1, VOCAB, size=n).tolist(), m)
            for n, m in [(3, 6), (7, 5), (2, 8), (5, 4)]]
    cb = ContinuousBatcher(eng, queue_depth=16).start()
    try:
        futs = [cb.submit(p, max_new_tokens=m) for p, m in jobs]
        outs = [[int(t) for t in f.result(timeout=60)] for f in futs]
        st = cb.stats()
    finally:
        cb.stop()
    assert outs == [_ref(p, m) for p, m in jobs]
    assert st["spec_k"] == 2 and 0.0 <= st["spec_accept_rate"] <= 1.0
    assert eng.free_pages == eng.allocator.max_pages
    proposed = _metric("zoo_tpu_serving_gen_spec_proposed_total")
    assert proposed == eng.spec_proposed > 0
    assert _metric("zoo_tpu_serving_gen_spec_accepted_total") == \
        eng.spec_accepted
    assert _metric("zoo_tpu_serving_gen_tokens_total") == \
        sum(m for _, m in jobs) - len(jobs)


def test_speculative_sampled_and_eos():
    """Sampled speculation keeps the budget and the vocabulary; greedy
    with an eos stops at its first occurrence, even mid-round."""
    eng = _engine(max_slots=2, spec_k=3, drafter=True)
    greedy = _ref([4, 19, 7], 8)
    eos = greedy[2]
    k = greedy.index(eos)
    cb = ContinuousBatcher(eng, queue_depth=8).start()
    try:
        sampled = cb.submit([9, 2, 31], max_new_tokens=10,
                            temperature=0.8).result(60)
        stopped = cb.submit([4, 19, 7], max_new_tokens=8,
                            eos_id=eos).result(60)
    finally:
        cb.stop()
    assert len(sampled) == 10 and all(0 <= int(t) < VOCAB for t in sampled)
    assert [int(t) for t in stopped] == greedy[:k + 1]


def test_batcher_chunked_and_speculative_together_exact():
    """Both levers at once, as a served mix: long prompts reach the
    drafter's cache chunk by chunk, short ones by its buckets, and every
    greedy stream is the JAX engine's."""
    eng = _engine(max_slots=2, prefill_chunk=4, spec_k=2, drafter=True)
    rs = np.random.RandomState(14)
    jobs = [(rs.randint(1, VOCAB, size=n).tolist(), m)
            for n, m in [(1, 3), (11, 5), (17, 6), (24, 2), (5, 9), (12, 1),
                         (7, 7)]]
    cb = ContinuousBatcher(eng, queue_depth=16).start()
    try:
        futs = []
        for p, m in jobs:
            futs.append(cb.submit(p, max_new_tokens=m))
            time.sleep(0.002)
        outs = [[int(t) for t in f.result(timeout=60)] for f in futs]
    finally:
        cb.stop()
    assert outs == [_ref(p, m) for p, m in jobs]
    assert eng.spec_proposed > 0
    assert _metric("zoo_tpu_serving_gen_prefill_chunks_total") > 0
    assert eng.free_pages == eng.allocator.max_pages


def test_mixed_levers_warm_every_program_once():
    eng = _engine(max_slots=2, prefill_chunk=4, spec_k=2, drafter=True)
    n = eng.warm()
    buckets = len(eng.prompt_buckets)
    # prefill and draft_prefill per bucket, step, chunk, draft_chunk,
    # draft, verify
    assert n == 2 * buckets + 5 == eng.stats()["warmed_programs"]
    assert eng.warm() == 0
    assert _engine(role="prefill").warm() == buckets + 1
    assert _engine(role="decode").warm() == 2


def test_load_generator_takes_a_drafter():
    jnet, params, tnet, jd, dparams, td = _nets()
    tnet.init(torch.Generator().manual_seed(0))
    tnet.set_params(_tparams(params))
    td.init(torch.Generator().manual_seed(0))
    td.set_params(_tparams(dparams))
    im = InferenceModel().load_generator(tnet, max_slots=2, max_context=SEQ,
                                         page_size=8, spec_k=2, drafter=td)
    eng = im.generator
    assert eng.spec_k == 2 and eng.drafter is td
    assert torch.equal(eng.drafter_params["tok_embed"],
                       td.params()["tok_embed"])
    (slot, first), = eng.admit([([5, 9, 2], 6, 0.0)])
    assert _drive(eng, slot, first, 3, 6) == _ref([5, 9, 2], 6)


# -- the handoff --------------------------------------------------------------

def _export(eng, prompt, max_new=4):
    if eng.prefill_chunk > 0:
        slot, = eng.admit_partial([(prompt, max_new, 0.0)])
        while eng.prefilling_slots:
            eng.prefill_step()
    else:
        (slot, _), = eng.admit([(prompt, max_new, 0.0)])
    return eng.export_handoff(slot)


def _decode_stream(dec, blob, max_new):
    slot = dec.admit_from_handoff(blob, max_new)
    out = [int(blob["last_token"])]
    active = np.zeros((dec.max_slots,), np.bool_)
    active[slot] = True
    while len(out) < max_new:
        out.append(int(dec.step(active)[slot]))
    dec.release(slot)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_handoff_crosses_the_packages_both_ways(dtype):
    """For each pool dtype, a blob goes port → port, JAX → port and port
    → JAX through the wire codec and JSON; the arrays round-trip bit for
    bit and every decode continues the JAX monolithic stream."""
    kv = KV[dtype]
    prompt, max_new = [5, 9, 2, 14, 3, 8, 1, 12, 40, 7, 2], 6
    mono = _engine("jax", cache_dtype=kv)
    (slot, first), = mono.admit([(prompt, max_new, 0.0)])
    ref = [first]
    active = np.zeros((mono.max_slots,), np.bool_)
    active[slot] = True
    while len(ref) < max_new:
        ref.append(int(mono.step(active)[slot]))

    pre = _engine(role="prefill", cache_dtype=kv)
    blob = _export(pre, prompt, max_new)
    assert pre.free_pages == pre.allocator.max_pages
    assert blob["kv_dtype"] == dtype and blob["seq_len"] == len(prompt)
    wire = json.loads(json.dumps(tkvc.handoff_to_wire(blob)))
    back = tkvc.handoff_from_wire(wire)
    for name in ("k", "v", "k_scales", "v_scales"):
        if blob[name] is None:
            assert back[name] is None
        else:
            assert back[name].dtype == blob[name].dtype
            np.testing.assert_array_equal(back[name], blob[name])
    assert tkvc.handoff_nbytes(back) == tkvc.handoff_nbytes(blob) > 0
    assert _decode_stream(_engine(role="decode", cache_dtype=kv), back,
                          max_new) == ref

    jblob = _export(_engine("jax", role="prefill", cache_dtype=kv), prompt,
                    max_new)
    from_jax = tkvc.handoff_from_wire(json.loads(json.dumps(
        jkvc.handoff_to_wire(jblob))))
    to_jax = jkvc.handoff_from_wire(json.loads(json.dumps(wire)))
    for name in ("k", "v"):             # the codec, bit for bit both ways
        np.testing.assert_array_equal(
            from_jax[name], np.asarray(jblob[name]).view(from_jax[name].dtype))
        np.testing.assert_array_equal(
            np.asarray(to_jax[name]).view(blob[name].dtype), blob[name])
    assert _decode_stream(_engine(role="decode", cache_dtype=kv), from_jax,
                          max_new) == ref
    assert _decode_stream(_engine("jax", role="decode", cache_dtype=kv),
                          to_jax, max_new) == ref


def test_handoff_after_chunked_prefill_and_beside_neighbours():
    """The exported pages carry a chunk-accumulated prefix; a blob
    admitted mid-decode leaves its neighbour's stream as it was."""
    rs = np.random.RandomState(4)
    pa, pb = list(range(1, 20)), rs.randint(1, VOCAB, size=5).tolist()
    pre = _engine(role="prefill", prefill_chunk=4)
    dec = _engine(role="decode")
    blob_a, blob_b = _export(pre, pa, 6), _export(pre, pb, 10)
    sb = dec.admit_from_handoff(blob_b, 10)
    out_b = [int(blob_b["last_token"])]
    active = np.zeros((dec.max_slots,), np.bool_)
    active[sb] = True
    sa, out_a = None, []
    for i in range(9):
        if i == 3:
            sa = dec.admit_from_handoff(blob_a, 6)
            out_a.append(int(blob_a["last_token"]))
            active[sa] = True
        toks = dec.step(active)
        out_b.append(int(toks[sb]))
        if sa is not None and active[sa]:
            out_a.append(int(toks[sa]))
            active[sa] = len(out_a) < 6
    assert out_b == _ref(pb, 10)
    assert out_a == _ref(pa, 6)


def test_handoff_blob_and_role_validation():
    pre = _engine(role="prefill")
    blob = _export(pre, [1, 2, 3])
    for eng, bad in ((_engine(role="decode", page_size=16), blob),
                     (_engine(role="decode", cache_dtype="int8"), blob),
                     (_engine(role="decode"), dict(blob, version=99)),
                     (_engine(role="decode"), dict(blob, seq_len=SEQ)),
                     (_engine(role="decode"), dict(blob, k=blob["k"][:, :0]))):
        with pytest.raises(ValueError):
            eng.admit_from_handoff(bad, 4)
        assert eng.free_pages == eng.allocator.max_pages   # untouched
        assert eng.slots_active == 0
    with pytest.raises(ValueError):
        _engine(role="frontend")
    with pytest.raises(ValueError):
        _engine(role="decode", spec_k=2, self_draft=True)
    assert _engine(role="prefill").stats()["role"] == "prefill"
    eng = _engine(prefill_chunk=4)
    slot, = eng.admit_partial([([1] * 9, 2, 0.0)])
    with pytest.raises(ValueError, match="mid-chunked"):
        eng.export_handoff(slot)
    with pytest.raises(ValueError, match="not active"):
        eng.export_handoff(3)


def test_batcher_prefill_and_handoff_futures_roundtrip():
    prompt = [8, 3, 17, 2, 9]
    pre_cb = ContinuousBatcher(_engine(role="prefill", prefill_chunk=4))
    dec_cb = ContinuousBatcher(_engine(role="decode"))
    pre_cb.start()
    dec_cb.start()
    try:
        blob = pre_cb.submit_prefill(prompt, max_new_tokens=7).result(60)
        assert blob["seq_len"] == len(prompt)
        got = dec_cb.submit_handoff(blob, max_new_tokens=7).result(60)
        assert [int(t) for t in got] == _ref(prompt, 7)
        with pytest.raises(ValueError):
            dec_cb.submit_handoff(blob, max_new_tokens=1)
        assert pre_cb.drain() and dec_cb.drain()
    finally:
        pre_cb.stop()
        dec_cb.stop()
    assert _metric("zoo_tpu_serving_gen_handoff_pages_leaked") == 0
    snap = tobs.snapshot()
    dirs = {v["labels"]["direction"]: v["value"] for v in
            snap["zoo_tpu_serving_gen_handoffs_total"]["values"]}
    assert dirs == {"out": 1, "in": 1}
    assert snap["zoo_tpu_serving_gen_handoff_seconds"]["values"][0][
        "count"] == 1
    for eng in (pre_cb.engine, dec_cb.engine):
        assert eng.free_pages == eng.allocator.max_pages


def test_drain_audit_reclaims_an_orphaned_slot():
    eng = _engine(role="decode")
    cb = ContinuousBatcher(eng).start()
    try:
        blob = _export(_engine(role="prefill"), [4, 5, 6], 5)
        eng.admit_from_handoff(blob, 5)    # a splice no request owns
        assert cb.drain()
    finally:
        cb.stop()
    assert _metric("zoo_tpu_serving_gen_handoff_pages_leaked") == 1
    assert eng.free_pages == eng.allocator.max_pages


def test_drain_waits_for_an_admission_in_flight():
    """drain() called while the loop is inside an admission (the popped
    request holds a slot but has not joined the active set) waits for
    the iteration: the request finishes exactly and the audit counts no
    page as leaked."""
    eng = _engine(max_slots=2)
    entered, release = threading.Event(), threading.Event()
    real = eng.admit

    def admit(reqs):
        out = real(reqs)                   # the slot is claimed
        entered.set()
        release.wait(10)
        return out
    eng.admit = admit
    cb = ContinuousBatcher(eng).start()
    drained = []
    try:
        f = cb.submit([4, 19, 7], max_new_tokens=4)
        assert entered.wait(10)
        t = threading.Thread(
            target=lambda: drained.append(cb.drain(timeout=30)))
        t.start()
        time.sleep(0.05)
        release.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert [int(x) for x in f.result(10)] == _ref([4, 19, 7], 4)
    finally:
        release.set()
        cb.stop()
    assert drained == [True]
    assert _metric("zoo_tpu_serving_gen_handoff_pages_leaked") == 0
    assert eng.free_pages == eng.allocator.max_pages


# -- fault points -------------------------------------------------------------

def test_unarmed_point_is_a_noop():
    p = faults.point("test/noop")
    assert not p.armed
    p.fire()
    p.fire(replica="r0")
    assert p.corrupt([1.0, 2.0]) == [1.0, 2.0]
    assert _metric("zoo_tpu_faults_injected_total") == 0


def test_error_and_kill_behaviors():
    p = faults.point("test/err")
    faults.arm("test/err", "error")
    with pytest.raises(InjectedFaultError):
        p.fire()
    faults.arm("test/err", "kill")
    with pytest.raises(InjectedKillError):
        p.fire()
    assert issubclass(InjectedKillError, InjectedFaultError)
    vals = {v["labels"]["kind"]: v["value"] for v in
            tobs.snapshot()["zoo_tpu_faults_injected_total"]["values"]}
    assert vals == {"error": 1, "kill": 1}


def test_delay_behavior_sleeps():
    p = faults.point("test/delay")
    faults.arm("test/delay", "delay", seconds=0.05)
    t0 = time.monotonic()
    p.fire()
    assert time.monotonic() - t0 >= 0.05


def test_corrupt_behavior_poisons_arrays():
    p = faults.point("test/corrupt")
    faults.arm("test/corrupt", "corrupt")
    assert np.isnan(np.asarray(p.corrupt(np.ones((2, 2),
                                                 np.float32)))).all()
    faults.arm("test/corrupt", "corrupt")
    assert p.corrupt(np.asarray([2, 3], np.int32)).tolist() == [3, 2]
    faults.arm("test/corrupt", "corrupt")
    p.fire()                       # corrupt never fires through fire()
    vals = {v["labels"]["kind"]: v["value"] for v in
            tobs.snapshot()["zoo_tpu_faults_injected_total"]["values"]}
    assert vals["corrupt"] == 2


def test_wedge_blocks_until_disarmed():
    p = faults.point("test/wedge")
    faults.arm("test/wedge", "wedge", seconds=20.0)
    done = threading.Event()

    def worker():
        p.fire()
        done.set()
    t = threading.Thread(target=worker, daemon=True)
    t.start()
    assert not done.wait(0.1)
    faults.disarm("test/wedge")
    assert done.wait(5)
    t.join(timeout=5)


def test_times_budget_auto_disarms():
    p = faults.point("test/times")
    faults.arm("test/times", "error", times=2)
    for _ in range(2):
        with pytest.raises(InjectedFaultError):
            p.fire()
    p.fire()
    assert not p.armed and p._spec is None


def test_where_selector_and_probability():
    p = faults.point("test/where")
    faults.arm("test/where", "error", where={"replica": "r1"})
    p.fire(replica="r0")
    p.fire()
    with pytest.raises(InjectedFaultError):
        p.fire(replica="r1")
    q = faults.point("test/p")
    faults.arm("test/p", "error", p=0.0)
    for _ in range(50):
        q.fire()
    assert _metric("zoo_tpu_faults_injected_total") == 1


def test_disarm_all_and_introspection():
    faults.arm("test/a", "error")
    faults.arm("test/b", "delay", seconds=1.0, times=3)
    armed = faults.armed()
    assert armed["test/a"]["kind"] == "error"
    assert armed["test/b"] == {"kind": "delay", "fired": 0, "seconds": 1.0,
                               "times": 3}
    faults.disarm_all()
    assert faults.armed() == {}
    assert "test/a" in faults.points()


def test_env_grammar_arms_points(monkeypatch):
    monkeypatch.setenv(
        "ZOO_TPU_FAULTS", "env/kill=kill:times=3:where_replica=r0;"
        "env/slow=delay:0.25;garbage-no-equals;env/badkind=frobnicate")
    faults.reset_faults()
    p = faults.point("env/kill")
    spec = p.status()["armed"]
    assert (spec["kind"], spec["times"], spec["where"]) == (
        "kill", 3, {"replica": "r0"})
    assert faults.point("env/slow").status()["armed"] == {
        "kind": "delay", "fired": 0, "seconds": 0.25}
    assert faults.point("env/badkind").status()["armed"] is None
    p.fire(replica="r1")
    with pytest.raises(InjectedKillError):
        p.fire(replica="r0")


def test_env_not_reparsed_after_first_use(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_FAULTS", "late/point=error")
    faults.reset_faults()
    faults.point("other/point")
    monkeypatch.setenv("ZOO_TPU_FAULTS", "late/point=delay:9")
    assert faults.point("late/point").status()["armed"]["kind"] == "error"


def test_unarmed_fire_has_no_measurable_overhead():
    p = faults.point("test/hot")
    assert p._spec is None
    assert faults.FaultPoint.__slots__ == ("name", "_spec")
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        p.fire()
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 3e-6, f"unarmed fire costs {per_call:.2e}s"


def test_dispatch_fault_fails_one_batch_and_the_dispatcher_goes_on():
    class Echo:
        def predict(self, x):
            return np.asarray(x) * 2
    b = DynamicBatcher(Echo(), max_batch_size=4, max_wait_ms=1).start()
    try:
        faults.arm("batcher/dispatch", "error", times=1)
        with pytest.raises(InjectedFaultError):
            b.submit([np.ones((1, 3), np.float32)]).result(10)
        out = b.submit([np.ones((2, 3), np.float32)]).result(10)
    finally:
        b.stop()
    np.testing.assert_array_equal(out, np.full((2, 3), 2.0, np.float32))
    assert _metric("zoo_tpu_serving_errors_total") == 1


# -- the batcher's failure paths ----------------------------------------------

def _wait(cond, seconds=10.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and not cond():
        time.sleep(0.002)
    return cond()


def test_batcher_drain_mid_generation_and_mid_chunk():
    """drain() lands while two sequences decode and a long prompt is
    mid-chunked-prefill: the resident ones finish exactly, the queued one
    fails retryably, and every page returns."""
    eng = _engine(max_slots=3, prefill_chunk=2)
    long_p = list(range(3, 27))
    cb = ContinuousBatcher(eng, queue_depth=8).start()
    try:
        faults.arm("generation/decode_step", "delay", seconds=0.05)
        f0 = cb.submit([4, 19, 7], max_new_tokens=6)
        f1 = cb.submit([9, 2], max_new_tokens=5)
        f2 = cb.submit(long_p, max_new_tokens=4)
        assert _wait(lambda: eng.slots_active == 3 and eng.prefilling_slots)
        f3 = cb.submit([5], max_new_tokens=4)
        assert cb.drain(timeout=30) is True
        assert [int(t) for t in f0.result(5)] == _ref([4, 19, 7], 6)
        assert [int(t) for t in f1.result(5)] == _ref([9, 2], 5)
        assert [int(t) for t in f2.result(5)] == _ref(long_p, 4)
        with pytest.raises(RuntimeError, match="draining"):
            f3.result(5)
        assert eng.slots_active == 0
        assert eng.free_pages == eng.allocator.max_pages
        with pytest.raises(RuntimeError, match="draining"):
            cb.submit([1], max_new_tokens=2)
    finally:
        faults.disarm_all()
        cb.stop()


@pytest.mark.parametrize("spec", [False, True])
def test_decode_kill_reclaims_pages_and_the_loop_serves_on(spec):
    """A kill at ``generation/decode_step`` (in a plain step, or at the
    head of a speculative round) fails the resident request, strands no
    page, and the loop serves the next request exactly."""
    eng = _engine(max_slots=2, **(dict(spec_k=2, drafter=True) if spec
                                  else {}))
    cb = ContinuousBatcher(eng, queue_depth=8).start()
    try:
        faults.arm("generation/decode_step", "kill", times=1)
        with pytest.raises(InjectedKillError):
            cb.submit([4, 19, 7], max_new_tokens=16).result(timeout=30)
        assert _wait(lambda: eng.free_pages == eng.allocator.max_pages)
        assert eng.slots_active == 0
        out = cb.submit([4, 19, 7], max_new_tokens=4).result(30)
        assert [int(t) for t in out] == _ref([4, 19, 7], 4)
    finally:
        cb.stop()
    if spec:
        assert eng.spec_proposed > 0
