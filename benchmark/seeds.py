"""Seeds derived from the run's ``--seed``: one per purpose, rank and
sample, so that each is fixed by the seed and no two draw alike."""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed from ``seed`` (any integer) and ``parts``."""
    key = "/".join(str(p) for p in (int(seed),) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1
