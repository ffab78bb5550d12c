"""Plain reference of MF top-k serving: every item scored in float64, the
seen items masked, a top-k; and the judge of a served answer against it.

Imports nothing of the package under test.  An answer is a request's
``(user_ids [B], item_ids [B, k], scores [B, k])``.  Judging it gives three
numbers:

* ``topk_gap``: the widest gap by which the served j-th item's true score
  (float64) lies below the reference's j-th best, over users and ranks;
* ``score_err``: the widest gap between a served score and the true score
  of the item it is served for;
* ``bad_ids``: served ids out of the catalog, repeated in a row, or (with
  the seen filter) seen by the user.
"""
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

Answer = Tuple[np.ndarray, np.ndarray, np.ndarray]


class SeenSets:
    """Each user's distinct items, as a CSR built from the raw log."""

    def __init__(self, users: np.ndarray, items: np.ndarray, num_users: int, num_items: int):
        keys = np.unique(np.asarray(users, np.int64) * num_items + np.asarray(items, np.int64))
        self.cols = keys % num_items
        self.indptr = np.searchsorted(keys, np.arange(num_users + 1, dtype=np.int64) * num_items)

    def rows(self, users: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(row index in users, item)`` of every seen pair of ``users``."""
        starts, stops = self.indptr[users], self.indptr[users + 1]
        counts = stops - starts
        row = np.repeat(np.arange(len(users)), counts)
        offset = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        return row, self.cols[np.repeat(starts, counts) + offset]


class Tables:
    """The served model's weights, as the benchmark made them."""

    def __init__(self, weights: Dict[str, torch.Tensor], device, dtype=torch.float64):
        self.ue = weights['user_embeddings'].to(device, dtype)
        self.ie = weights['item_embeddings'].to(device, dtype)
        self.ub = weights['user_biases'].to(device, dtype)
        self.ib = weights['item_biases'].to(device, dtype)
        self.num_items = self.ie.shape[0]

    def scores(self, users: torch.Tensor) -> torch.Tensor:
        return self.ue[users] @ self.ie.T + self.ib[None, :] + self.ub[users][:, None]


def _mask(scores: torch.Tensor, seen: Optional[SeenSets], users: np.ndarray) -> torch.Tensor:
    if seen is None:
        return scores
    row, col = seen.rows(users)
    scores[torch.as_tensor(row, device=scores.device),
           torch.as_tensor(col, device=scores.device)] = -torch.inf
    return scores


def judge(answers: Iterable[Answer], tables: Tables, seen: Optional[SeenSets],
          block: int = 64) -> Dict[str, float]:
    """The three numbers over every answer, from float64 scores."""
    gap = err = 0.0
    bad = 0
    device = tables.ie.device
    for users, ids, served in answers:
        for lo in range(0, len(users), block):
            u = np.asarray(users[lo:lo + block], np.int64)
            i = np.asarray(ids[lo:lo + block], np.int64)
            s = torch.as_tensor(np.asarray(served[lo:lo + block], np.float64), device=device)
            valid = (i >= 0) & (i < tables.num_items)
            sorted_ids = np.sort(np.where(valid, i, -1), axis=1)
            repeated = np.zeros_like(valid)
            repeated[:, 1:] = (sorted_ids[:, 1:] == sorted_ids[:, :-1]) & (sorted_ids[:, 1:] >= 0)
            bad += int((~valid).sum()) + int(repeated.sum())
            full = tables.scores(torch.as_tensor(u, device=device))
            ids_t = torch.as_tensor(np.where(valid, i, 0), device=device)
            true = full.gather(1, ids_t)
            if seen is not None:
                row, col = seen.rows(u)
                served_keys = np.arange(len(u))[:, None] * tables.num_items + i
                bad += int(np.isin(served_keys, row * tables.num_items + col).sum())
            best = torch.topk(_mask(full, seen, u), i.shape[1], dim=1).values
            ok = torch.as_tensor(valid, device=device)
            gap = max(gap, float(torch.where(ok, best - true, 0).max()))
            err = max(err, float(torch.where(ok, (s - true).abs(), 0).max()))
            del full
    return {'topk_gap': gap, 'score_err': err, 'bad_ids': float(bad)}


def lower_precision_answers(requests: List[np.ndarray], weights: Dict[str, torch.Tensor],
                            seen: Optional[SeenSets], k: int, device,
                            block: int = 256) -> List[Answer]:
    """The control: the reference in the program's place, scored one step
    below the configured float32, in TF32 (float32 matmuls on tensor
    cores), with the same seen mask and a top-k."""
    tables = Tables(weights, device, torch.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = []
        for users in requests:
            ids, scores = [], []
            for lo in range(0, len(users), block):
                u = np.asarray(users[lo:lo + block], np.int64)
                full = _mask(tables.scores(torch.as_tensor(u, device=device)), seen, u)
                top = torch.topk(full, k, dim=1)
                ids.append(top.indices.cpu().numpy())
                scores.append(top.values.cpu().numpy())
            out.append((users, np.concatenate(ids), np.concatenate(scores)))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
