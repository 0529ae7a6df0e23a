"""Generation's capacity levers on the card: a chunked-prefill stream and
a speculative stream served by the ``ContinuousBatcher`` on the card,
each held to the same engine on the CPU (the port's plain versions).

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none. This file imports no JAX, so it runs on a machine
that has none:

    python -m pytest --noconftest tests/test_torch_generate_levers_cuda.py -q

A narrow GPT stack (2 blocks, hidden 128, 2 heads of 64) at a 2048-token
context, so every decode step on the card goes through B11 (the target's
and the drafter's); the chunks attend densely on both sides. Greedy
streams must be equal, TF32 off.
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo

SEQ, VOCAB = 2048, 97
NET = dict(n_block=2, hidden_size=128, n_head=2, vocab=VOCAB, seq_len=SEQ,
           hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
DRAFT = dict(NET, n_block=1, hidden_size=64, n_head=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tzoo.init_nncontext(seed=0)
    yield torch.device("cuda")
    tzoo.reset_nncontext()


def _serve(eng, jobs, temperature=0.0):
    from analytics_zoo_tpu_torch.pipeline.inference import ContinuousBatcher
    cb = ContinuousBatcher(eng, queue_depth=8).start()
    try:
        futs = [cb.submit(p, max_new_tokens=m, temperature=temperature)
                for p, m in jobs]
        return [[int(t) for t in f.result(timeout=600)] for f in futs]
    finally:
        cb.stop()


def _nets():
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.transformer \
        import TransformerLayer
    net, drafter = TransformerLayer(**NET), TransformerLayer(**DRAFT)
    return (net, net.build(torch.Generator().manual_seed(0), (SEQ,)),
            drafter, drafter.build(torch.Generator().manual_seed(1), (SEQ,)))


@pytest.mark.cuda
@pytest.mark.parametrize("lever", ["chunked", "speculative"])
def test_lever_streams_on_card_match_the_cpu_port(cuda, lever):
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.pipeline.inference import GenerationEngine
    net, params, drafter, dparams = _nets()
    kw = dict(max_slots=2, max_context=SEQ, page_size=16)
    if lever == "chunked":
        kw["prefill_chunk"] = 64
    else:
        kw.update(spec_k=3, drafter=drafter, drafter_params=dparams)
    rs = np.random.RandomState(0)
    jobs = [(rs.randint(1, VOCAB, size=n).tolist(), m)
            for n, m in [(300, 12), (40, 16)]]
    want = _serve(GenerationEngine(net, params, device="cpu", **kw), jobs)
    fa.reset_launches()
    card = GenerationEngine(net, params, device=cuda, **kw)
    got = _serve(card, jobs)
    assert got == want
    assert fa.launches["flash_decode"] > 0
    assert card.free_pages == card.allocator.max_pages
    if lever == "speculative":
        assert card.spec_proposed > 0


@pytest.mark.cuda
def test_sampled_speculative_streams_repeat_on_card(cuda):
    """Sampled speculation on the card (the uniforms and the residual's
    draw on CUDA generators): two engines of one seed give the same
    streams, within the budget and the vocabulary."""
    from analytics_zoo_tpu_torch.pipeline.inference import GenerationEngine
    net, params, drafter, dparams = _nets()
    jobs = [(list(range(3, 40)), 16), ([5, 9, 2], 12)]
    runs = []
    for _ in range(2):
        eng = GenerationEngine(net, params, device=cuda, max_slots=2,
                               max_context=SEQ, page_size=16, spec_k=3,
                               drafter=drafter, drafter_params=dparams,
                               rng_seed=5)
        # one request at a time: each program draws with its step's
        # seed, so the schedule must repeat too
        runs.append([_serve(eng, [job], temperature=0.8)[0]
                     for job in jobs])
        assert eng.spec_proposed > 0
        assert eng.free_pages == eng.allocator.max_pages
    assert runs[0] == runs[1]
    assert [len(t) for t in runs[0]] == [16, 12]
    assert all(0 <= t < VOCAB for s in runs[0] for t in s)
