"""The one traffic generator: it reads a traffic file's parameters and the
seed, and gives the pool of work items and the order the units take them.

* ``pool`` items, each of ``shots_per_unit`` (default 1) distinct
  candidates drawn without replacement from the configuration's
  ``candidates`` (source positions), or, with no candidates, one derived
  seed each (the seed of a data vector);
* a closed loop: unit ``i`` takes item ``(offset + i) % pool``, the offset
  drawn from the seed. Every seed gives the same sizes and arrivals; only
  which items, and in which order, changes.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Schedule", "schedule"]


class Schedule:
    def __init__(self, seed: int, pool, offset: int):
        self.seed, self.pool, self.offset = int(seed), pool, int(offset)

    def item(self, i: int) -> int:
        return (self.offset + int(i)) % len(self.pool)


def schedule(traffic: dict, seed: int, candidates: int) -> Schedule:
    if traffic.get("loop", "closed") != "closed":
        raise ValueError(f"unknown loop {traffic.get('loop')!r}: only 'closed' is defined")
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x7EA1])
    pool, per = int(traffic["pool"]), int(traffic.get("shots_per_unit", 1))
    if candidates > 0:
        items = rng.choice(candidates, size=pool * per, replace=False).reshape(pool, per)
    else:
        items = rng.integers(0, 2**62, size=(pool, 1))
    return Schedule(seed, [[int(v) for v in row] for row in items],
                    int(rng.integers(pool)))
