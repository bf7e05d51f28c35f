"""Seeds of the run's parts, derived from ``--seed`` (any whole
number): the same seed gives the same weights and batches."""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the part named by ``tags``."""
    key = "/".join(map(str, (seed,) + tags)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1
