"""Seeded interactions with a skewed item popularity, for serving.

A copy of the generator of ``chip_smoke.py`` ``serving_data``: users drawn
uniformly, item popularity ranks ``floor(num_items * u^power)`` (power 3:
low ranks are popular) mapped to ids through a seeded permutation.
Duplicated pairs are left in; the package under test and the reference each
drop them.
"""
from typing import Dict

import numpy as np


def generate_interactions(num_users: int, num_items: int, num_interactions: int,
                          seed: int, power: float = 3.0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    users = rng.integers(0, num_users, num_interactions)
    ranks = np.floor(num_items * rng.random(num_interactions) ** power).astype(np.int64)
    items = rng.permutation(num_items)[ranks]
    return {'users': users.astype(np.int64), 'items': items.astype(np.int64)}
