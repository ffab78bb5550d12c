"""Serving requests: a fixed ladder of request sizes, in a seeded order.

Every seed gets the same set of sizes, log-spaced between ``min`` and
``max`` users, and sends them in cycles, each cycle in its own seeded
order; each request's users are distinct and drawn uniformly.  So seeds
change which users are asked and in what order, not how much work a cycle
holds, and a window of whole cycles holds the same work for every seed.
"""
from typing import Iterator, List, Tuple

import numpy as np


def size_ladder(low: int, high: int, count: int) -> List[int]:
    if count == 1:
        return [int(high)]
    steps = np.arange(count) / (count - 1)
    return sorted({int(round(low * (high / low) ** s)) for s in steps})


class Requests:
    """An endless, seeded stream of ``(user_ids, last_of_its_cycle)``."""

    def __init__(self, num_users: int, low: int, high: int, ladder: int, seed: int):
        self.num_users = num_users
        self.sizes = size_ladder(low, high, ladder)
        self.rng = np.random.default_rng([int(seed), 17])

    def __iter__(self) -> Iterator[Tuple[np.ndarray, bool]]:
        while True:
            order = self.rng.permutation(self.sizes)
            for i, size in enumerate(order):
                yield (self.rng.choice(self.num_users, int(size), replace=False),
                       i == len(order) - 1)
