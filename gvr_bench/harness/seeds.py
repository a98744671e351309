"""Every random stream of a run, derived from `--seed` by name.

A stream is keyed by the run's seed and a tuple of tags (what it draws,
which document, which layer), so the same seed gives the same inputs on
every run, and the reference can draw a document's rows again without
keeping them.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream `tags` of run `seed` (any whole
    number, however large)."""
    text = repr((int(seed),) + tuple(tags)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))
