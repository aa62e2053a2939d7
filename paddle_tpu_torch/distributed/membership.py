"""Liveness by heartbeat: the port's copy of
`paddle_tpu/distributed/elastic/membership.py:30 live_by_beat`, the pure
function the reference's training membership and its serving replicas
both judge by. The replica handle (`inference/serving/replica.py`) uses
it for its lease."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

__all__ = ["live_by_beat"]


def live_by_beat(beats: Dict[int, float], ttl: float,
                 now: Optional[float] = None) -> List[int]:
    """Members whose last beat is at most ``ttl`` seconds old."""
    if now is None:
        now = time.monotonic()
    return sorted(m for m, t in beats.items() if now - t <= ttl)
