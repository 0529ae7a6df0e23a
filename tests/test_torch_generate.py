"""The PyTorch port's generation slice against the JAX package's, on the
same numpy weights and cache states: ``TransformerLayer.prefill`` /
``decode_step`` / ``generate``, ``GenerationEngine``,
``ContinuousBatcher`` and ``InferenceModel.load_generator``.

A toy GPT stack (2 blocks, hidden 32, 2 heads, seq_len 32, vocab 61,
dropouts 0, as ``tests/test_generate.py``); the JAX weights are bridged
into the port, and cache states cross with ``kv_cache_from_numpy`` so
both sides decode from one state. The JAX decode kernel (B11) runs in
Pallas interpret mode, the port's plain version on CPU tensors.

Tolerances, as a fraction of max(1, |ref|): 1e-5 for f32 logits and
cache rows (the same products, sums in another order); 2e-2 for a bf16
cache and 5e-2 for an int8 one, the reference suite's own bounds for
its kv-dtype conformance matrix (``tests/test_generate.py:635-636``).
Greedy streams must be identical.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu.pipeline.api.keras.layers import transformer as jtr
from analytics_zoo_tpu.pipeline.inference.generation import \
    GenerationEngine as JEngine
from analytics_zoo_tpu_torch.bridge import (kv_cache_from_numpy,
                                            kv_cache_to_numpy,
                                            params_from_numpy)
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    transformer as ttr
from analytics_zoo_tpu_torch.pipeline.inference import (
    ContinuousBatcher, GenerationEngine, InferenceModel, QueueFullError,
    resolve_kv_dtype)

SEQ, VOCAB = 32, 61
TOY = dict(n_block=2, hidden_size=32, n_head=2, vocab=VOCAB,
           hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    yield
    tobs.reset_metrics()
    tzoo.reset_nncontext()


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _nets(seq=SEQ, impl=None):
    """The JAX net, its host params, and the port's net on them."""
    jnet = jtr.TransformerLayer(seq_len=seq, attention_impl=impl, **TOY)
    params = jax.device_get(jnet.build(jax.random.key(0), (seq,)))
    tnet = ttr.TransformerLayer(seq_len=seq, attention_impl=impl, **TOY)
    return jnet, params, tnet, params_from_numpy(params)


def _prompts(rs, lens, width):
    ids = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rs.randint(1, VOCAB, size=n)
    return ids, np.asarray(lens, np.int32)


def _jax_cache(jnet, slots, dtype, rs, context=SEQ, page=8):
    """A JAX cache with random stale rows and a permuted page table, so
    untouched and unwritten rows are visible in the comparison."""
    c = jax.device_get(jnet.init_kv_cache(slots, context, page_size=page,
                                          dtype=JDT[dtype]))
    pages = c.k_pages.shape[1]
    table = rs.permutation(pages).astype(np.int32).reshape(
        c.page_table.shape)
    stale = np.asarray(rs.randn(*c.k_pages.shape) * (60 if dtype == "int8"
                                                      else 1))
    c = c._replace(k_pages=stale.astype(c.k_pages.dtype),
                   v_pages=(-stale).astype(c.v_pages.dtype),
                   page_table=table)
    return c


def _assert_caches_close(port, jcache, tol):
    got = kv_cache_to_numpy(port)
    want = jax.device_get(jcache)
    np.testing.assert_array_equal(got["seq_lens"], want.seq_lens)
    np.testing.assert_array_equal(got["page_table"], want.page_table)
    for f in ("k_pages", "v_pages", "k_scales", "v_scales"):
        if getattr(want, f) is None:
            assert got[f] is None
        else:
            _close(got[f], np.asarray(getattr(want, f), np.float32), tol, f)


# -- the model layer ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_prefill_matches_jax(dtype):
    jnet, params, tnet, tparams = _nets()
    rs = np.random.RandomState(0)
    jcache = _jax_cache(jnet, 3, dtype, rs)
    ids, plens = _prompts(rs, [5, 0, 9], 16)        # slot 1 untouched
    jc, jlg = jnet.prefill(params, jax.tree_util.tree_map(
        jnp.asarray, jcache), jnp.asarray(ids), jnp.asarray(plens))
    tc, tlg = tnet.prefill(tparams, kv_cache_from_numpy(jcache),
                           torch.from_numpy(ids), torch.from_numpy(plens))
    _close(tlg[[0, 2]], np.asarray(jlg)[[0, 2]], 1e-5, "logits")
    _assert_caches_close(tc, jc, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_decode_steps_match_jax(dtype):
    """Six teacher-forced decode steps from one bridged cache state,
    with a slot frozen for two of them: every step's logits and the
    final cache."""
    jnet, params, tnet, tparams = _nets()
    rs = np.random.RandomState(1)
    ids, plens = _prompts(rs, [3, 7, 1], 8)
    jc, jlg = jnet.prefill(params, jax.tree_util.tree_map(
        jnp.asarray, _jax_cache(jnet, 3, dtype, rs)), jnp.asarray(ids),
        jnp.asarray(plens))
    tc = kv_cache_from_numpy(jax.device_get(jc))
    tok = np.array(jnp.argmax(jlg, -1), np.int32)
    for i in range(6):
        active = np.asarray([True, i not in (2, 3), True])
        jc, jlg = jnet.decode_step(params, jc, jnp.asarray(tok),
                                   active=jnp.asarray(active))
        tc, tlg = tnet.decode_step(tparams, tc, torch.from_numpy(tok),
                                   active=torch.from_numpy(active))
        _close(tlg, jlg, TOL[dtype], f"step {i}")
        tok = np.array(jnp.argmax(jlg, -1), np.int32)
    _assert_caches_close(tc, jc, TOL[dtype])
    assert tc.seq_lens.tolist() == [9, 11, 7]


def test_decode_step_through_b11_matches_jax_kernel(monkeypatch):
    """A decode step on the flash route (``attention_impl="flash"``,
    SEQ 128 so the cache's T is 128-divisible) after an "xla" prefill:
    JAX runs its decode kernel in interpret mode, the port B11's plain
    version, once per block on both sides."""
    jnet, params, tnet, tparams = _nets(seq=128)
    jflash = jtr.TransformerLayer(seq_len=128, attention_impl="flash",
                                  **TOY)
    tflash = ttr.TransformerLayer(seq_len=128, attention_impl="flash",
                                  **TOY)
    calls = []
    real = tfa.flash_decode_attention

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)
    monkeypatch.setattr(tfa, "flash_decode_attention", spy)
    rs = np.random.RandomState(2)
    ids, plens = _prompts(rs, [20, 5, 57], 64)
    jc, jlg = jnet.prefill(params, jnet.init_kv_cache(3, 128, page_size=16),
                           jnp.asarray(ids), jnp.asarray(plens))
    tc = kv_cache_from_numpy(jax.device_get(jc))
    tok = np.array(jnp.argmax(jlg, -1), np.int32)
    before = jfa.invocations
    jc, jlg = jflash.decode_step(params, jc, jnp.asarray(tok))
    tc, tlg = tflash.decode_step(tparams, tc, torch.from_numpy(tok))
    assert jfa.invocations - before == 1   # traced once inside its scan
    assert calls == [(3, 128, 2, 16)] * 2
    _close(tlg, jlg, 1e-5)
    _assert_caches_close(tc, jc, 1e-5)


def test_generate_greedy_matches_jax():
    jnet, params, tnet, tparams = _nets()
    rs = np.random.RandomState(3)
    ids, plens = _prompts(rs, [3, 5, 2], 5)
    jbuf, jlens = jnet.generate(params, ids, prompt_lens=plens,
                                max_new_tokens=6)
    tbuf, tlens = tnet.generate(tparams, ids, prompt_lens=plens,
                                max_new_tokens=6)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    # eos stops a slot at its first occurrence, eos included
    eos = int(np.asarray(jbuf)[0, 3 + 2])
    jbuf, jlens = jnet.generate(params, ids, prompt_lens=plens,
                                max_new_tokens=8, eos_id=eos)
    tbuf, tlens = tnet.generate(tparams, ids, prompt_lens=plens,
                                max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    for i, n in enumerate(np.asarray(jlens)):
        np.testing.assert_array_equal(tbuf[i, :n].numpy(),
                                      np.asarray(jbuf)[i, :n])


def test_generate_sampling_is_seeded():
    _, _, tnet, tparams = _nets()
    ids = np.asarray([[4, 9, 2]], np.int32)
    runs = [tnet.generate(tparams, ids, max_new_tokens=8, temperature=1.0,
                          top_k=20, rng=seed)[0] for seed in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].max()) < VOCAB


# -- the engine and the batcher -----------------------------------------------

def _engines(dtype="f32", slots=4):
    jnet, params, tnet, _ = _nets()
    kw = dict(max_slots=slots, max_context=SEQ, page_size=8,
              cache_dtype=dtype)
    return (JEngine(jnet, jax.tree_util.tree_map(jnp.asarray, params),
                    **kw), GenerationEngine(tnet, params, **kw))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_engine_admit_step_release_matches_jax_engine(dtype):
    jeng, teng = _engines(dtype)
    assert teng.stats()["kv_dtype"] == ("float32" if dtype == "f32"
                                        else "int8")
    rs = np.random.RandomState(13)
    for plen, max_new in [(3, 6), (9, 5)]:
        prompt = rs.randint(1, VOCAB, size=plen).tolist()
        ref = [int(t) for t in jeng.generate(prompt,
                                             max_new_tokens=max_new)[0]]
        assert [int(t) for t in teng.generate(
            prompt, max_new_tokens=max_new)[0]] == ref
        (slot, first), = teng.admit([(prompt, max_new, 0.0)])
        got = [first]
        active = np.zeros((teng.max_slots,), np.bool_)
        active[slot] = True
        while len(got) < max_new:
            got.append(int(teng.step(active)[slot]))
        teng.release(slot)
        assert got == ref, (prompt, got, ref)
    assert teng.slots_active == 0


def test_engine_page_accounting_and_admission_gate():
    _, eng = _engines()
    total = eng.allocator.max_pages
    assert eng.free_pages == total
    # worst case reserved up front: ceil((3 + 12) / 8) = 2 pages
    (slot, _), = eng.admit([([1, 2, 3], 12, 0.0)])
    assert eng.free_pages == total - 2 and eng.slots_active == 1
    eng.release(slot)
    assert eng.free_pages == total
    with pytest.raises(ValueError):
        eng.admit([(list(range(1, SEQ + 6)), 1, 0.0)])
    admitted = eng.admit([([i + 1], 2, 0.0) for i in range(eng.max_slots)])
    assert not eng.can_admit(1, 1)
    with pytest.raises(MemoryError):
        eng.admit([([1], 1, 0.0)])
    for slot, _ in admitted:
        eng.release(slot)
    assert eng.can_admit(1, 1)


def test_engine_warm_runs_every_program_once():
    _, eng = _engines(slots=2)
    before = eng.cache.clone()
    n = eng.warm()
    assert n == len(eng.prompt_buckets) + 1 == 7
    assert eng.warm() == 0
    # warm-up ran on a scratch copy: the serving cache is untouched
    for a, b in zip(eng.cache, before):
        assert a is None and b is None or torch.equal(a, b)
    assert eng.stats()["warmed_programs"] == 7


def test_continuous_batching_matches_jax_engine():
    jeng, teng = _engines(slots=2)      # 2 slots, 5 requests: churn
    rs = np.random.RandomState(4)
    jobs = [(rs.randint(1, VOCAB, size=n).tolist(), m)
            for n, m in [(3, 6), (7, 4), (2, 8), (5, 5), (4, 7)]]
    refs = [[int(t) for t in jeng.generate(p, max_new_tokens=m)[0]]
            for p, m in jobs]
    cb = ContinuousBatcher(teng, queue_depth=16).start()
    try:
        futs = []
        for i, (p, m) in enumerate(jobs):
            futs.append(cb.submit(p, max_new_tokens=m))
            if i < 2:
                time.sleep(0.01)
        outs = [[int(t) for t in f.result(timeout=60)] for f in futs]
    finally:
        cb.stop()
    assert outs == refs
    assert teng.slots_active == 0
    assert teng.free_pages == teng.allocator.max_pages
    snap = tobs.snapshot()
    assert snap["zoo_tpu_serving_gen_ttft_seconds"]["values"][0][
        "count"] == len(jobs)
    # the first token comes from the prefill, the rest from steps
    assert snap["zoo_tpu_serving_gen_tokens_total"]["values"][0][
        "value"] == sum(m for _, m in jobs) - len(jobs)
    assert snap["zoo_tpu_serving_gen_slots_active"]["values"][0][
        "value"] == 0
    assert snap["zoo_tpu_serving_gen_free_pages"]["values"][0][
        "value"] == teng.allocator.max_pages
    for name in ("decode_admit", "decode_step", "decode_retire"):
        assert snap[f"zoo_tpu_{name}_seconds"]["values"][0]["count"] > 0


def test_continuous_batcher_many_clients_stress():
    """More client threads than cores submit at once into 3 slots, with
    a short switch interval: every request gets its budget and the
    sequential engine's stream, and the pool refills exactly."""
    import sys
    import threading
    _, eng = _engines(slots=3)
    rs = np.random.RandomState(9)
    jobs = [(rs.randint(1, VOCAB, size=int(n)).tolist(), int(m))
            for n, m in zip(rs.randint(1, 12, size=24),
                            rs.randint(1, 6, size=24))]
    refs = [[int(t) for t in eng.generate(p, max_new_tokens=m)[0]]
            for p, m in jobs]
    cb = ContinuousBatcher(eng, queue_depth=len(jobs)).start()
    outs = [None] * len(jobs)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(c):
            futs = [(i, cb.submit(jobs[i][0], max_new_tokens=jobs[i][1]))
                    for i in range(c, len(jobs), 12)]
            for i, f in futs:
                outs[i] = [int(t) for t in f.result(timeout=60)]
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        cb.stop()
    assert outs == refs
    assert eng.slots_active == 0
    assert eng.free_pages == eng.allocator.max_pages
    assert tobs.snapshot()["zoo_tpu_serving_gen_ttft_seconds"]["values"][0][
        "count"] == len(jobs)


def test_continuous_batcher_queue_full_and_stop_fails_pending():
    _, eng = _engines(slots=2)
    cb = ContinuousBatcher(eng, queue_depth=2)     # not started
    cb.submit([1, 2], max_new_tokens=4)
    f2 = cb.submit([3], max_new_tokens=4)
    assert tobs.snapshot()["zoo_tpu_serving_gen_queue_depth"]["values"][0][
        "value"] == 2
    with pytest.raises(QueueFullError):
        cb.submit([4], max_new_tokens=4)
    assert tobs.snapshot()["zoo_tpu_serving_errors_total"]["values"][0][
        "value"] == 1
    with pytest.raises(ValueError):
        cb.submit(list(range(1, SEQ + 1)), max_new_tokens=2)
    cb.stop()
    with pytest.raises(RuntimeError):
        f2.result(timeout=5)
    with pytest.raises(RuntimeError):
        cb.submit([1], max_new_tokens=2)


def _drafter_pair(vocab=VOCAB, seq=SEQ):
    """A one-block drafter for the validation cases, in both packages."""
    kw = dict(n_block=1, hidden_size=16, n_head=2, vocab=vocab, seq_len=seq,
              hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
    jd = jtr.TransformerLayer(**kw)
    return jd, jax.device_get(jd.build(jax.random.key(7), (seq,))), \
        ttr.TransformerLayer(**kw)


@pytest.mark.parametrize("case", [
    "spec_without_drafter", "spec_env_without_drafter", "spec_with_role",
    "bad_role", "drafter_vocab", "drafter_context", "absurd_spec_k"])
def test_engine_validates_levers_as_the_reference(monkeypatch, case):
    """Each lever's misconfiguration raises the reference's ValueError,
    in the port and in the JAX engine alike."""
    jnet, params, tnet, _ = _nets()
    kw = dict(max_slots=2, max_context=SEQ, page_size=8)
    jd, dparams, td = _drafter_pair(
        vocab=VOCAB + 1 if case == "drafter_vocab" else VOCAB,
        seq=SEQ // 2 if case == "drafter_context" else SEQ)
    spec = dict(spec_k=2, drafter=(jd, td), drafter_params=dparams)
    kw.update({
        "spec_without_drafter": {"spec_k": 2},
        "spec_env_without_drafter": {},
        "spec_with_role": dict(spec, role="decode"),
        "bad_role": {"role": "frontend"},
        "drafter_vocab": spec, "drafter_context": spec,
        "absurd_spec_k": dict(spec, spec_k=1001)}[case])
    if case == "spec_env_without_drafter":
        monkeypatch.setenv("ZOO_TPU_SPEC_K", "3")
    for eng, net, params_, side in ((JEngine, jnet, params, 0),
                                    (GenerationEngine, tnet, params, 1)):
        args = dict(kw)
        if "drafter" in args:
            args["drafter"] = args["drafter"][side]
        with pytest.raises(ValueError):
            eng(net, params_, **args)


def test_resolve_kv_dtype_and_engine_environment(monkeypatch):
    assert resolve_kv_dtype("bf16") is torch.bfloat16
    assert resolve_kv_dtype(torch.int8) is torch.int8
    monkeypatch.setenv("ZOO_TPU_KV_DTYPE", "int8")
    assert resolve_kv_dtype() is torch.int8
    with pytest.raises(ValueError):
        resolve_kv_dtype("fp8")
    monkeypatch.setenv("ZOO_TPU_GEN_SLOTS", "3")
    monkeypatch.setenv("ZOO_TPU_GEN_PAGE_SIZE", "4")
    _, params, tnet, _ = _nets()
    eng = GenerationEngine(tnet, params)
    assert (eng.max_slots, eng.page_size, eng.max_context) == (3, 4, SEQ)
    assert eng.cache.k_pages.dtype == torch.int8
    assert eng.cache.k_pages.device.type == "cpu"


def test_inference_model_load_generator_and_generate():
    jeng, _ = _engines()
    _, params, tnet, tparams = _nets()
    im = InferenceModel()
    with pytest.raises(RuntimeError):
        im.generate([1, 2])
    assert im.generator is None
    tnet.init(torch.Generator().manual_seed(0))
    tnet.set_params(tparams)
    im.load_generator(tnet, max_slots=2, max_context=SEQ, page_size=8)
    assert isinstance(im.generator, GenerationEngine)
    got = im.generate([[4, 19, 7], [5]], max_new_tokens=5)
    want = jeng.generate([[4, 19, 7], [5]], max_new_tokens=5)
    assert [g.tolist() for g in got] == [np.asarray(w).tolist()
                                         for w in want]
