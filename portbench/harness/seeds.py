"""Seeded random streams of the benchmark's inputs.

Every input of a run (the fold, the tables, the features, the requests)
comes from ``--seed`` through a stream of its own, so one seed gives the
same inputs and two streams never share draws. A seed may be any whole
number up to 2**64 - 1."""

from __future__ import annotations

import numpy as np
import torch

STREAMS = ("fold", "users", "holdout", "tables", "features", "requests",
           "sample", "steps")


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of the run seeded ``seed``."""
    state = np.random.SeedSequence(
        [int(seed) & (2**64 - 1), STREAMS.index(name)]).generate_state(
            1, np.uint64)
    return int(state[0] >> np.uint64(1))


def rng(seed: int, name: str) -> np.random.Generator:
    """A host generator for the stream ``name``."""
    return np.random.default_rng(stream_seed(seed, name))


def generator(seed: int, name: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stream ``name``."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name))
