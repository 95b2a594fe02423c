"""Host-side helpers."""

from typing import Sequence


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest bucket when none is)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
