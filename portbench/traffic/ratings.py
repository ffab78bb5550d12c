"""Generated ratings with MovieLens-like marginals, made on the card.

The distribution of ``collie_tpu_torch/data/synthetic.py``
``generate_interactions_df`` with its parameters, vectorised in torch so
that 10M ratings take well under a second on the card (the numpy original
takes ~36 s on a CPU for that size): users and items with planted latent
factors; Zipf-like item popularity (rank^-0.8) and user activity
(rank^-0.5) under seeded permutations; candidate pairs oversampled and
deduplicated keeping the first draw; with ``affinity_bias`` the kept set is
the top ``num_ratings`` of ``affinity_bias * affinity + Gumbel noise`` (a
softmax-weighted sample without replacement), kept in draw order; every
user and every item guaranteed one pair; 1-5 stars from the affinity plus
noise at the quantiles 0.06, 0.17, 0.44, 0.78 of the score.

The stream is torch's, not numpy's: the same seed gives the same ratings on
the same kind of card, not the numbers the original would draw.
"""
from typing import Dict

import torch


def _first_occurrence(keys: torch.Tensor) -> torch.Tensor:
    """Positions of the first occurrence of each distinct key, ascending."""
    _, inverse = torch.unique(keys, return_inverse=True)
    positions = torch.arange(keys.numel(), device=keys.device)
    first = torch.full((int(inverse.max()) + 1,), keys.numel(), dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inverse, positions, reduce='amin')
    return torch.sort(first).values


def _skewed_cdf(n: int, power: float, generator: torch.Generator) -> torch.Tensor:
    weights = 1.0 / torch.arange(1, n + 1, dtype=torch.float64,
                                 device=generator.device) ** power
    weights = weights[torch.randperm(n, generator=generator, device=generator.device)]
    cdf = torch.cumsum(weights / weights.sum(), 0)
    cdf[-1] = 1.0
    return cdf


def _draw(cdf: torch.Tensor, n: int, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device, dtype=torch.float64)
    return torch.clamp(torch.searchsorted(cdf, u, right=True), max=cdf.numel() - 1)


def generate_ratings(num_users: int, num_items: int, num_ratings: int, seed: int,
                     device, latent_dim: int = 8, noise: float = 0.25,
                     affinity_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """``{'users', 'items'}`` int64 and ``'ratings'`` int64 in 1..5, each
    ``[num_ratings]`` on ``device``; (user, item) pairs are distinct."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    user_factors = torch.randn(num_users, latent_dim, generator=g, device=device)
    item_factors = torch.randn(num_items, latent_dim, generator=g, device=device)
    item_cdf = _skewed_cdf(num_items, 0.8, g)
    user_cdf = _skewed_cdf(num_users, 0.5, g)

    needed = num_ratings * (2 if affinity_bias > 0 else 1)
    oversample = 1.6 * (2 if affinity_bias > 0 else 1)
    for _ in range(8):
        n_draw = int(num_ratings * oversample)
        users = _draw(user_cdf, n_draw, g)
        items = _draw(item_cdf, n_draw, g)
        first = _first_occurrence(users * num_items + items)
        if first.numel() >= needed or n_draw >= 20 * num_ratings:
            break
        oversample *= 2
    users, items = users[first], items[first]

    def affinity(u, i):
        a = (user_factors[u] * item_factors[i]).sum(dim=1)
        return a / a.std()

    if affinity_bias > 0 and users.numel() > num_ratings:
        u01 = torch.rand(users.numel(), generator=g, device=device)
        gumbel = -torch.log(-torch.log(u01.clamp(1e-12, 1 - 1e-7)))
        keep = torch.topk(affinity_bias * affinity(users, items) + gumbel, num_ratings).indices
        keep = torch.sort(keep).values           # draw order
        users, items = users[keep], items[keep]

    arange_u = torch.arange(num_users, device=device)
    arange_i = torch.arange(num_items, device=device)
    users = torch.cat([torch.randint(0, num_users, (num_items,), generator=g, device=device),
                       arange_u, users])
    items = torch.cat([arange_i,
                       torch.randint(0, num_items, (num_users,), generator=g, device=device),
                       items])
    first = _first_occurrence(users * num_items + items)[:num_ratings]
    users, items = users[first], items[first]

    score = affinity(users, items) + noise * torch.randn(users.numel(), generator=g,
                                                         device=device)
    ordered = torch.sort(score).values
    n = ordered.numel()
    # numpy's default (linear) quantiles
    q = torch.tensor([0.06, 0.17, 0.44, 0.78], dtype=torch.float64, device=device) * (n - 1)
    lo = q.floor().long()
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = (q - lo).to(ordered.dtype)
    cuts = ordered[lo] + frac * (ordered[hi] - ordered[lo])
    ratings = torch.bucketize(score, cuts, right=True) + 1     # np.digitize
    return {'users': users, 'items': items, 'ratings': ratings.to(torch.int64)}
