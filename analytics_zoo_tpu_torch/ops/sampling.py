"""Token sampling for the decode loop (port of
``analytics_zoo_tpu/ops/sampling.py``).

The greedy/temperature switch is per slot: slots with ``temperature <=
0`` take the argmax, the rest draw from the (optionally top-k
truncated) temperature softmax. Greedy is ``argmax`` on both sides, so
greedy streams are the reference's exactly. Sampled tokens draw from a
``torch.Generator`` seeded with an int seed (``ops/rng.py``, the
engine's ``fold_in(seed, step)``); they are not ``jax.random``'s draws.

Speculative decoding (Leviathan et al., "Fast Inference from
Transformers via Speculative Decoding") scores drafts against
:func:`sampling_probs`, the exact distribution :func:`sample_tokens`
draws from, and :func:`speculative_accept` runs the rejection test:
draft ``d_i`` is accepted with probability ``min(1, p_i(d_i) /
q_i(d_i))``, and the first rejection is replaced by a draw from
``norm(max(p - q, 0))``. The emitted stream is distributed as
target-only sampling; for greedy slots ``p`` is one-hot, the test is
``d_i == argmax p_i`` and the residual the argmax itself, so greedy
speculation is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops.rng import fold_in, generator

_NEG_INF = -1e30


def _temperatures(temperature, shape, device) -> torch.Tensor:
    return torch.as_tensor(temperature, dtype=torch.float32,
                           device=device).expand(shape)


def _scaled(logits, temp, top_k: int) -> torch.Tensor:
    """Temperature-scaled logits, top-k truncated to -1e30."""
    scaled = logits / temp.clamp_min(1e-6)[..., None]
    if top_k and 0 < top_k < logits.shape[-1]:
        kth = scaled.topk(top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, _NEG_INF))
    return scaled


def sample_tokens(seed: int, logits: torch.Tensor, temperature,
                  top_k: int = 0) -> torch.Tensor:
    """Next-token ids for a batch of slots.

    logits: (S, V); temperature: a scalar or (S,) (host values or a
    tensor), ``<= 0`` meaning greedy for that slot; ``top_k``: 0 or
    negative disables truncation. The draw is Gumbel-max on a generator
    seeded with ``seed``; when every temperature is a host value <= 0
    nothing is drawn. Returns (S,) int32 on the logits' device.
    """
    logits = logits.float()
    greedy = logits.argmax(-1).to(torch.int32)
    if not isinstance(temperature, torch.Tensor) and \
            not (np.asarray(temperature) > 0).any():
        return greedy
    temp = _temperatures(temperature, logits.shape[:1], logits.device)
    scaled = _scaled(logits, temp, top_k)
    u = torch.rand(scaled.shape, generator=generator(seed, logits.device),
                   device=logits.device)
    sampled = (scaled - torch.log(-torch.log(u))).argmax(-1)
    return torch.where(temp > 0, sampled.to(torch.int32), greedy)


def sampling_probs(logits: torch.Tensor, temperature,
                   top_k: int = 0) -> torch.Tensor:
    """The per-slot distribution :func:`sample_tokens` draws from, as
    explicit probabilities: a one-hot at the argmax for greedy slots,
    else the top-k truncated temperature softmax. logits: (..., S, V) →
    (..., S, V) f32."""
    logits = logits.float()
    temp = _temperatures(temperature, logits.shape[:-1], logits.device)
    probs = torch.softmax(_scaled(logits, temp, top_k), dim=-1)
    greedy = torch.nn.functional.one_hot(
        logits.argmax(-1), logits.shape[-1]).float()
    return torch.where((temp > 0)[..., None], probs, greedy)


def speculative_accept(seed: int, p: torch.Tensor, q: torch.Tensor,
                       drafts: torch.Tensor):
    """Rejection-sampling acceptance for one speculative round.

    p / q: (S, K, V) f32, the target's and the drafter's sampling
    distributions at each of the K draft positions (both from
    :func:`sampling_probs`, so greedy slots carry one-hots); drafts:
    (S, K) int proposed ids. Returns ``(n_accept, corrected)``, (S,)
    int32 each: the length of the accepted prefix (position i accepted
    iff ``u_i q_i(d_i) < p_i(d_i)`` and every earlier one was), and a
    token drawn from the residual ``norm(max(p - q, 0))`` at the first
    rejected position (meaningful only where ``n_accept < K``). The two
    draws (the uniforms, then the residual's Gumbel-max) come from
    generators seeded with ``fold_in(seed, 0)`` and ``fold_in(seed,
    1)``; greedy needs neither to be exact.
    """
    k = drafts.shape[1]
    d = drafts.long()[..., None]
    p_d = torch.gather(p, -1, d)[..., 0]
    q_d = torch.gather(q, -1, d)[..., 0]
    u = torch.rand(drafts.shape, generator=generator(fold_in(seed, 0),
                                                     p.device),
                   device=p.device)
    # u < p/q without the division (q_d is 0 off a greedy drafter's pick)
    accept = u * q_d < p_d
    n_accept = torch.cumprod(accept.to(torch.int32), dim=1).sum(1)
    idx = n_accept.clamp(max=k - 1).long()
    rows = torch.arange(p.shape[0], device=p.device)
    residual = (p[rows, idx] - q[rows, idx]).clamp_min(0.0)
    g = torch.rand(residual.shape, generator=generator(fold_in(seed, 1),
                                                       p.device),
                   device=p.device)
    corrected = (torch.log(residual + 1e-30) -
                 torch.log(-torch.log(g))).argmax(-1)
    return n_accept.to(torch.int32), corrected.to(torch.int32)
