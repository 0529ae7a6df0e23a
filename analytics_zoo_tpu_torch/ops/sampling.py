"""Token sampling for the decode loop (port of
``analytics_zoo_tpu/ops/sampling.py``, without ``speculative_accept``,
which waits for speculative decoding).

The greedy/temperature switch is per slot: slots with ``temperature <=
0`` take the argmax, the rest draw from the (optionally top-k
truncated) temperature softmax. Greedy is ``argmax`` on both sides, so
greedy streams are the reference's exactly. Sampled tokens draw from a
``torch.Generator`` seeded with an int seed (``ops/rng.py``, the
engine's ``fold_in(seed, step)``); they are not ``jax.random``'s draws.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops.rng import generator

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
