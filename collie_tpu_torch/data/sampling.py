"""Vectorized negative sampling.

The vectorized replacement for the reference's per-``__getitem__`` rejection
loops (the reference's ``collie/interactions/datasets.py:390-445`` and the
batch samplers in ``samplers.py:11-127``).  Whole batches of ``[B, K]``
negative IDs are drawn at once on the host with numpy; *exact* mode re-draws
collisions (against the user's positives, and duplicates within a row) for a
bounded number of vectorized rounds, then — like the reference's
``max_number_of_samples_to_consider`` fallback — accepts whatever remains.
"""
import numpy as np


class NegativeSampler:
    """Samples ``[batch, num_negative_samples]`` negative item IDs for a batch of users.

    Exact mode reproduces the reference's guarantees (sampled negatives never
    collide with a user's positives, no duplicates within a row, up to a
    bounded resample budget); approximate mode is a single uniform draw
    (reference ``datasets.py:432-443``).
    """

    def __init__(self, interactions, max_resample_rounds: int = 20):
        self.interactions = interactions
        self.num_items = interactions.num_items
        self.num_negative_samples = interactions.num_negative_samples
        self.exact = interactions.exact_negative_sampling
        self.max_resample_rounds = max_resample_rounds

    def sample(self, user_ids: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        B = len(user_ids)
        K = self.num_negative_samples
        negatives = rng.integers(0, self.num_items, size=(B, K), dtype=np.int64)
        if not self.exact:
            return negatives

        users = np.asarray(user_ids, dtype=np.int64)[:, None]
        for _ in range(self.max_resample_rounds):
            bad = self.interactions.contains_pairs(
                np.broadcast_to(users, (B, K)), negatives
            )
            bad |= _duplicate_within_row_mask(negatives)
            n_bad = int(bad.sum())
            if n_bad == 0:
                break
            negatives[bad] = rng.integers(0, self.num_items, size=n_bad, dtype=np.int64)
        return negatives


def _duplicate_within_row_mask(arr: np.ndarray) -> np.ndarray:
    """Mark duplicated values within each row (all but the first occurrence)."""
    order = np.argsort(arr, axis=1, kind='stable')
    sorted_arr = np.take_along_axis(arr, order, axis=1)
    dup_sorted = np.zeros_like(arr, dtype=bool)
    dup_sorted[:, 1:] = sorted_arr[:, 1:] == sorted_arr[:, :-1]
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    return dup
