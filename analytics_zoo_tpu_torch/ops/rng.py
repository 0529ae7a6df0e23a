"""Seeds for the noise a training step draws (dropout), the counterpart
of the JAX package's ``jax.random`` keys.

A seed is a plain int in ``[0, 2**63)``. :func:`fold_in` derives a new
seed from a seed and an int, as ``jax.random.fold_in`` derives a key, so
a step's seed (``fold_in(base, step)``) gives each layer its own
(``fold_in(step_seed, layer_index)``) without any shared state. A layer
turns its seed into a ``torch.Generator`` only where it draws
(:func:`generator`), so a block recomputed under activation
checkpointing draws the same mask again: the generator is rebuilt from
the same seed. The numbers differ from ``jax.random``'s; tests that
compare with the JAX package set dropout to 0.
"""

from __future__ import annotations

import torch

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit ints."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``seed`` and ``data``, in ``[0, 2**63)``."""
    return _mix(_mix(int(seed) & _MASK) ^ (int(data) & _MASK)) >> 1


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
