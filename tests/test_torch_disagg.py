"""The port's disaggregated generation (``fleet.py``'s
``DisaggReplica``/``DisaggRouter``, the engine's handoff, the serving
routes' resolution) against the JAX package's: the reference tests'
cases (``test_disagg.py``), on the toy transformer of the generation
tests (2 blocks, hidden 32, 2 heads, seq_len 32, vocab 61), its JAX
weights bridged into the port.

The contract is exactness: a greedy stream made by prefill on one
engine, a page handoff and decode on another equals the monolithic
engine's stream, and the port's streams equal the JAX package's, for
every KV dtype, after chunked prefill, beside staggered neighbours,
through the wire codec, and through a decode replica failing mid-wave.
Blobs also cross between the packages' replicas, both ways, inside a
router. A drained fleet refills its pages exactly (leak counter 0) and
a warmed pool runs no program it did not warm.
"""

from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.ops import kv_cache as jkvc
from analytics_zoo_tpu.pipeline.api.keras.layers import transformer as jtr
from analytics_zoo_tpu.pipeline.inference import batching as jb
from analytics_zoo_tpu.pipeline.inference import fleet as jfleet
from analytics_zoo_tpu.pipeline.inference import generation as jgen
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM
from analytics_zoo_tpu.pipeline.inference import serving as jsv
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.ops import kv_cache as tkvc
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    transformer as ttr
from analytics_zoo_tpu_torch.pipeline.inference import batching as tb
from analytics_zoo_tpu_torch.pipeline.inference import fleet as tfleet
from analytics_zoo_tpu_torch.pipeline.inference import generation as tgen
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel as TIM
from analytics_zoo_tpu_torch.pipeline.inference import serving as tsv

SEQ, VOCAB = 32, 61
TOY = dict(n_block=2, hidden_size=32, n_head=2, seq_len=SEQ, vocab=VOCAB,
           hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
TIMEOUT = 120


class Lib:
    def __init__(self, name, fleet, gen, batching, kvc, obs, serving, im):
        self.name, self.fleet, self.gen, self.batching = name, fleet, gen, \
            batching
        self.kvc, self.obs, self.serving, self.IM = kvc, obs, serving, im


T = Lib("port", tfleet, tgen, tb, tkvc, tobs, tsv, TIM)
J = Lib("jax", jfleet, jgen, jb, jkvc, jobs, jsv, JIM)
LIBS = (T, J)


@pytest.fixture(autouse=True)
def _fresh():
    tzoo.init_nncontext(seed=0, device="cpu")
    jinit(seed=0)
    tobs.reset_metrics()
    jobs.reset_metrics()
    yield
    tobs.reset_metrics()
    jobs.reset_metrics()
    tzoo.reset_nncontext()


_NETS = {}


def _nets():
    """(JAX net, host params, port net), built once."""
    if not _NETS:
        jnet = jtr.TransformerLayer(**TOY)
        _NETS["v"] = (jnet,
                      jax.device_get(jnet.build(jax.random.key(0), (SEQ,))),
                      ttr.TransformerLayer(**TOY))
    return _NETS["v"]


def _engine(lib, **kw):
    jnet, params, tnet = _nets()
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_context", SEQ)
    kw.setdefault("page_size", 8)
    if lib is J:
        return jgen.GenerationEngine(
            jnet, jax.tree_util.tree_map(jnp.asarray, params), **kw)
    return tgen.GenerationEngine(tnet, params, **kw)


_ENGINES = {}


def _cached(lib, **kw):
    """One engine per package and configuration, reused across cases
    (every stream below ends with its slot released and its pages
    back)."""
    key = (lib.name, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        _ENGINES[key] = _engine(lib, **kw)
    return _ENGINES[key]


def _mono_stream(lib, prompt, max_new, **kw):
    """The monolithic stream: one role="both" engine, admit, then
    steps."""
    eng = _cached(lib, **kw)
    (slot, first), = eng.admit([(prompt, max_new, 0.0)])
    out = [first]
    active = np.zeros((eng.max_slots,), np.bool_)
    active[slot] = True
    while len(out) < max_new:
        out.append(int(eng.step(active)[slot]))
    eng.release(slot)
    assert eng.free_pages == eng.allocator.max_pages
    return [int(t) for t in out]


def _export(eng, prompt, max_new=4):
    if eng.prefill_chunk > 0:
        slot, = eng.admit_partial([(prompt, max_new, 0.0)])
        while eng.prefilling_slots:
            eng.prefill_step()
    else:
        (slot, _), = eng.admit([(prompt, max_new, 0.0)])
    return eng.export_handoff(slot)


def _decode_stream(dec, blob, max_new):
    dslot = dec.admit_from_handoff(blob, max_new)
    out = [int(blob["last_token"])]
    active = np.zeros((dec.max_slots,), np.bool_)
    active[dslot] = True
    while len(out) < max_new:
        out.append(int(dec.step(active)[dslot]))
    dec.release(dslot)
    return out


def _pool_stream(lib, prompt, max_new, prefill_kw=None, decode_kw=None):
    pre = _cached(lib, role="prefill", **(prefill_kw or {}))
    dec = _cached(lib, role="decode", **(decode_kw or {}))
    blob = _export(pre, prompt, max_new)
    assert pre.free_pages == pre.allocator.max_pages
    assert pre.slots_active == 0
    out = _decode_stream(dec, blob, max_new)
    assert dec.free_pages == dec.allocator.max_pages
    return out


# -- the engine layer: the handoff is token-exact, every dtype ----------------

@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_handoff_stream_matches_monolithic(kv):
    """The port's prefill → handoff → decode stream against both
    packages' monolithic streams (the reference's own pools reproduce
    its monolithic stream in ``test_disagg.py``)."""
    rs = np.random.RandomState(2)
    for plen in (3, 11):
        prompt = rs.randint(1, VOCAB, size=plen).tolist()
        kw = {} if kv == "f32" else {"cache_dtype": kv}  # f32: default
        ref = _mono_stream(J, prompt, 8, **kw)
        assert _mono_stream(T, prompt, 8, **kw) == ref, (kv, plen)
        got = _pool_stream(T, prompt, 8, prefill_kw=kw, decode_kw=kw)
        assert got == ref, (kv, plen)


def test_handoff_after_chunked_prefill_is_exact():
    prompt = list(range(1, 20))
    got = {lib.name: _pool_stream(lib, prompt, 6,
                                  prefill_kw={"prefill_chunk": 4})
           for lib in LIBS}
    assert got["port"] == got["jax"] == _mono_stream(J, prompt, 6)


def test_staggered_admission_neighbor_invariance():
    rs = np.random.RandomState(4)
    pa, pb, pc = (rs.randint(1, VOCAB, size=n).tolist() for n in (5, 9, 3))
    got = {}
    for lib in LIBS:
        pre = _cached(lib, role="prefill")
        dec = _cached(lib, role="decode")
        blob_a = _export(pre, pa, 10)
        blob_b = _export(pre, pb, 10)
        sa = dec.admit_from_handoff(blob_a, 10)
        sb = dec.admit_from_handoff(blob_b, 10)
        out_a = [int(blob_a["last_token"])]
        out_b = [int(blob_b["last_token"])]
        out_c = []
        active = np.zeros((dec.max_slots,), np.bool_)
        active[sa] = active[sb] = True
        sc = None
        for i in range(9):
            if i == 3:  # mid-stream, a third handoff lands next door
                blob_c = _export(pre, pc, 4)
                sc = dec.admit_from_handoff(blob_c, 4)
                out_c.append(int(blob_c["last_token"]))
                active[sc] = True
            toks = dec.step(active)
            out_a.append(int(toks[sa]))
            out_b.append(int(toks[sb]))
            if sc is not None and active[sc]:
                out_c.append(int(toks[sc]))
                if len(out_c) >= 4:
                    active[sc] = False
        assert out_a == _mono_stream(lib, pa, 10)
        assert out_b == _mono_stream(lib, pb, 10)
        assert len(out_c) == 4
        for slot in (sa, sb, sc):
            dec.release(slot)
        got[lib.name] = (out_a, out_b, out_c)
    assert got["port"] == got["jax"]


def test_blob_validation_rejects_mismatched_geometry():
    for lib in LIBS:
        blob = _export(_engine(lib, role="prefill"), [1, 2, 3])
        with pytest.raises(ValueError):
            _engine(lib, role="decode", page_size=16).admit_from_handoff(
                dict(blob), 4)
        with pytest.raises(ValueError):
            _engine(lib, role="decode",
                    cache_dtype="int8").admit_from_handoff(dict(blob), 4)
        stale = dict(blob, version=99)
        dec = _engine(lib, role="decode")
        with pytest.raises(ValueError):
            dec.admit_from_handoff(stale, 4)
        # a rejected blob leaves the engine untouched
        assert dec.free_pages == dec.allocator.max_pages
        assert dec.slots_active == 0


def test_wire_codec_roundtrip_preserves_dtype_exactly():
    for kv in ("f32", "bf16", "int8"):
        pre = _engine(T, role="prefill", cache_dtype=kv)
        blob = _export(pre, [5, 9, 2, 14], 5)
        back = tkvc.handoff_from_wire(tkvc.handoff_to_wire(blob))
        assert back["kv_dtype"] == blob["kv_dtype"]
        assert back["seq_len"] == blob["seq_len"]
        assert back["k"].dtype == blob["k"].dtype
        np.testing.assert_array_equal(back["k"], blob["k"])
        np.testing.assert_array_equal(back["v"], blob["v"])
        if kv == "int8":
            np.testing.assert_array_equal(back["k_scales"],
                                          blob["k_scales"])
        else:
            assert back["k_scales"] is None
        dec = _engine(T, role="decode", cache_dtype=kv)
        assert _decode_stream(dec, back, 5) == _mono_stream(
            J, [5, 9, 2, 14], 5, cache_dtype=kv), kv


# -- the role surface ---------------------------------------------------------

def test_role_validation():
    jnet, params, tnet = _nets()
    for lib in LIBS:
        with pytest.raises(ValueError):
            _engine(lib, role="frontend")
        assert _engine(lib, role="prefill").stats()["role"] == "prefill"
    with pytest.raises(ValueError):  # speculation needs both phases
        tgen.GenerationEngine(tnet, params, max_slots=4, max_context=SEQ,
                              page_size=8, role="decode", spec_k=2,
                              drafter=tnet, drafter_params=params)


# -- the router: conformance, exactly once, the drain audit -------------------

def _router_prompts():
    rs = np.random.RandomState(7)
    return [rs.randint(1, VOCAB, size=n).tolist() for n in (3, 7, 5, 11)]


def _dying(blob, mx, eos):
    f = Future()
    f.set_exception(ConnectionError("killed mid-handoff"))
    return f


def test_router_greedy_conformance_and_exactly_once():
    """The port's router against the JAX package's monolithic streams
    (which the reference's router reproduces), before and after a
    decode replica fails."""
    prompts = _router_prompts()
    ref = [_mono_stream(J, p, 8) for p in prompts]
    for lib in (T,):
        router = lib.fleet.DisaggRouter.for_engine(
            _engine(lib, prefill_chunk=4), n_prefill=1, n_decode=2,
            eject_after=1)
        router.start()
        try:
            futs = [router.submit(p, max_new_tokens=8) for p in prompts]
            first = [f.result(TIMEOUT).tolist() for f in futs]
            assert first == ref
            # a decode replica fails between waves: its legs die with it,
            # the router re-prefills on the sibling, and every stream is
            # still the same
            victim = router.decode[0]
            victim.decode = _dying
            futs = [router.submit(p, max_new_tokens=8) for p in prompts]
            second = [f.result(TIMEOUT).tolist() for f in futs]
            assert second == ref
            assert not victim.admitting()
            retries = lib.obs.counter(
                "zoo_tpu_serving_gen_handoff_retries_total", help="x").value
            assert retries >= 1
            assert router.fleet_status()["replicas_admitting"] == 2
        finally:
            router.stop()


def test_router_short_request_resolves_at_prefill():
    """max_new 1 needs no decode leg: the prefill's token is the stream
    (the JAX package's monolithic one) and no pages ship."""
    prompts = _router_prompts()
    for lib in (T,):
        router = lib.fleet.DisaggRouter.for_engine(_engine(lib),
                                                   n_prefill=1, n_decode=1)
        router.start()
        try:
            got = [router.submit(p, max_new_tokens=1).result(TIMEOUT)
                   .tolist() for p in prompts]
            assert got == [_mono_stream(J, p, 1) for p in prompts]
            ho_in = lib.obs.counter("zoo_tpu_serving_gen_handoffs_total",
                                    help="x",
                                    labels={"direction": "in"}).value
            assert ho_in == 0
        finally:
            router.stop()


def test_router_drain_leak_counter_and_exact_refill():
    for lib in (T,):
        router = lib.fleet.DisaggRouter.for_engine(_engine(lib),
                                                   n_prefill=1, n_decode=2)
        router.start()
        try:
            for f in [router.submit(p, max_new_tokens=6)
                      for p in _router_prompts()]:
                f.result(TIMEOUT)
            assert router.drain()
            assert lib.obs.counter(
                "zoo_tpu_serving_gen_handoff_pages_leaked",
                help="x").value == 0
            for r in router.prefill + router.decode:
                assert r.free_pages() == r.total_pages(), r.name
            st = router.fleet_status()
            assert st["disagg"] is True
            assert sorted(r["role"] for r in st["replicas"]) == [
                "decode", "decode", "prefill"]
            assert st["pools"]["prefill"]["pages_free"] == \
                st["pools"]["prefill"]["pages_total"]
            assert [r["state"] for r in st["replicas"]] == ["drained"] * 3
            dec = st["pools"]["decode"]
            assert (dec["replicas"], dec["admitting"]) == (2, 0)
            assert dec["pages_free"] == dec["pages_total"] == sum(
                r.total_pages() for r in router.decode)
        finally:
            router.stop()


def test_spec_decode_incompatible_with_disagg():
    jnet, params, tnet = _nets()
    eng = tgen.GenerationEngine(tnet, params, max_slots=4, max_context=SEQ,
                                page_size=8, spec_k=2, drafter=tnet,
                                drafter_params=params)
    with pytest.raises(ValueError, match="speculative"):
        tfleet.DisaggRouter.for_engine(eng)


def test_no_new_program_under_disagg_traffic():
    """A warmed pool runs only programs it warmed (the reference counts
    XLA compiles; the port counts the engine's program keys: a prompt
    bucket, a step, an export or an import run for the first time is a
    new program)."""
    router = tfleet.DisaggRouter.for_engine(_engine(T, prefill_chunk=4),
                                            n_prefill=1, n_decode=2)
    router.start()
    try:
        engines = [r.engine for r in router.prefill + router.decode]
        warmed = [set(e._warmed_programs) for e in engines]
        assert all(warmed)
        rs = np.random.RandomState(9)
        reqs = [(1, 3), (9, 5), (2, 4), (17, 6), (5, 2), (12, 3), (7, 7),
                (3, 1)]
        futs = [router.submit(rs.randint(1, VOCAB, size=n).tolist(),
                              max_new_tokens=m) for n, m in reqs]
        for f, (_, m) in zip(futs, reqs):
            assert len(f.result(TIMEOUT)) == m
        assert [set(e._warmed_programs) for e in engines] == warmed
    finally:
        router.stop()


def test_blobs_cross_packages_inside_a_router():
    """A router of each package over a prefill replica of one package
    and a decode replica of the other: the JAX package's blobs decode on
    the port's replica and the port's on the JAX package's, with the
    monolithic streams."""
    prompts = _router_prompts()
    ref = [_mono_stream(J, p, 6) for p in prompts]
    for pre_lib, dec_lib, router_lib in ((J, T, T), (T, J, J)):
        router = router_lib.fleet.DisaggRouter(
            [pre_lib.fleet.DisaggReplica(
                "prefill0", _cached(pre_lib, role="prefill"))],
            [dec_lib.fleet.DisaggReplica(
                "decode0", _cached(dec_lib, role="decode"))])
        router.start()
        try:
            got = [router.submit(p, max_new_tokens=6).result(TIMEOUT)
                   .tolist() for p in prompts]
            assert got == ref, (pre_lib.name, dec_lib.name)
        finally:
            router.stop()


# -- the batcher surface: the pool's ingress ----------------------------------

def test_batcher_prefill_and_handoff_futures_roundtrip():
    prompt = [8, 3, 17, 2, 9]
    for lib in (T,):
        pre_cb = lib.batching.ContinuousBatcher(
            _engine(lib, role="prefill", prefill_chunk=4))
        dec_cb = lib.batching.ContinuousBatcher(_engine(lib, role="decode"))
        pre_cb.start()
        dec_cb.start()
        try:
            blob = pre_cb.submit_prefill(prompt,
                                         max_new_tokens=7).result(TIMEOUT)
            assert blob["seq_len"] == len(prompt)
            got = dec_cb.submit_handoff(blob,
                                        max_new_tokens=7).result(TIMEOUT)
            assert [int(t) for t in got] == _mono_stream(J, prompt, 7)
            assert pre_cb.drain() and dec_cb.drain()
        finally:
            pre_cb.stop()
            dec_cb.stop()


def test_disagg_replica_status_reports_role_and_pages():
    sts = {}
    for lib in LIBS:
        rep = lib.fleet.DisaggReplica("d0", _engine(lib, role="decode"))
        rep.start()
        try:
            st = rep.status()
            assert st["role"] == "decode"
            assert st["pages_free"] == st["pages_total"] > 0
            sts[lib.name] = {k: v for k, v in st.items() if k != "batcher"}
        finally:
            rep.stop()
    assert sts["port"] == sts["jax"]


def test_serving_resolves_disagg_router_from_env(monkeypatch):
    jnet, params, tnet = _nets()
    monkeypatch.setenv("ZOO_TPU_DISAGG", "1")
    monkeypatch.setenv("ZOO_TPU_DISAGG_PREFILL_REPLICAS", "1")
    monkeypatch.setenv("ZOO_TPU_DISAGG_DECODE_REPLICAS", "2")
    im = TIM()
    im.load_generator(tnet, params, max_slots=2, max_context=SEQ,
                      page_size=8)
    gb = tsv._resolve_gen_batcher(im, "auto")
    assert isinstance(gb, tfleet.DisaggRouter)
    assert len(gb.prefill) == 1 and len(gb.decode) == 2
    assert all(r.engine.device == im.generator.device
               for r in gb.prefill + gb.decode)
    # a pool worker's role engine keeps the plain batcher
    im2 = TIM()
    im2.load_generator(tnet, params, max_slots=2, max_context=SEQ,
                       page_size=8, role="decode")
    assert isinstance(tsv._resolve_gen_batcher(im2, "auto"),
                      tb.ContinuousBatcher)
    monkeypatch.setenv("ZOO_TPU_DISAGG", "0")
    assert isinstance(tsv._resolve_gen_batcher(im, "auto"),
                      tb.ContinuousBatcher)


def test_disagg_over_http_matches_colocated():
    """The routes end to end: a prefill server and a decode server of
    the port behind an ``HttpDisaggReplica`` each, driven by the port's
    router; every stream equals the JAX package's monolithic one."""
    jnet, params, tnet = _nets()
    prompts = _router_prompts()
    ref = [_mono_stream(J, p, 6) for p in prompts]
    for lib in (T,):
        net = tnet if lib is T else jnet
        p = params if lib is T else jax.tree_util.tree_map(jnp.asarray,
                                                            params)
        servers = []
        try:
            for role in ("prefill", "decode"):
                im = lib.IM()
                im.load_generator(net, p, max_slots=4, max_context=SEQ,
                                  page_size=8, role=role)
                servers.append(lib.serving.InferenceServer(
                    im, port=0, batcher=None).start())
            router = T.fleet.DisaggRouter(
                [T.fleet.HttpDisaggReplica(
                    f"http://127.0.0.1:{servers[0].port}", "prefill")],
                [T.fleet.HttpDisaggReplica(
                    f"http://127.0.0.1:{servers[1].port}", "decode")])
            router.start()
            try:
                got = [router.submit(q, max_new_tokens=6).result(TIMEOUT)
                       .tolist() for q in prompts]
                assert got == ref, lib.name
                st = router.fleet_status()
                assert st["pools"]["decode"]["pages_free"] == \
                    st["pools"]["decode"]["pages_total"] > 0
            finally:
                router.stop()
        finally:
            for s in servers:
                s.stop()
