"""Synthetic implicit/explicit datasets with planted low-rank structure.

The reference's integration tests and benchmarks run on MovieLens 100K, which
must be downloaded (the reference's ``collie/movielens/get_data.py:195-206``;
network required per ``README.md:218``).  This environment has no network
egress, so tests and benchmarks here run on a synthetic dataset of the same
shape (943 users x 1682 items x 100k interactions by default) with planted
latent factors — a model that learns recovers the structure, so ranking-metric
quality gates remain meaningful.
"""
import numpy as np
import pandas as pd


def generate_interactions_df(num_users: int = 943,
                             num_items: int = 1682,
                             num_interactions: int = 100_000,
                             latent_dim: int = 8,
                             noise: float = 0.25,
                             affinity_bias: float = 0.0,
                             seed: int = 42) -> pd.DataFrame:
    """Generate an explicit-feedback DataFrame with MovieLens-like marginals.

    Users and items get latent factors with popularity skew; each sampled
    (user, item) pair receives a 1-5 star rating driven by the latent affinity
    plus noise.  Returned columns match ``read_movielens_df``
    (reference ``get_data.py:12-59``): user_id, item_id, rating, timestamp.

    ``affinity_bias > 0`` makes the *observation process itself*
    affinity-dependent (users interact preferentially with items they like —
    the property real interaction logs have): candidate pairs are oversampled
    and the kept set is the top ``num_interactions`` by
    ``affinity_bias * affinity + Gumbel noise`` (a softmax-weighted sample
    without replacement via the Gumbel-top-k trick).  At large catalogs this
    is what keeps top-k ranking metrics meaningfully above chance; the
    default 0 preserves the pre-round-2 distribution that the calibrated
    quality gates (benchmarks/gates.json) were measured on.
    """
    rng = np.random.default_rng(seed)

    user_factors = rng.standard_normal((num_users, latent_dim)).astype(np.float32)
    item_factors = rng.standard_normal((num_items, latent_dim)).astype(np.float32)

    # Zipf-ish popularity so the item marginal looks like real catalog data
    item_pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    item_pop = rng.permutation(item_pop)
    item_pop /= item_pop.sum()
    user_act = 1.0 / np.arange(1, num_users + 1) ** 0.5
    user_act = rng.permutation(user_act)
    user_act /= user_act.sum()

    # oversample, then dedup (keep first) down to the requested count; at high
    # densities the skewed marginals collide a lot, so grow the draw until the
    # unique count suffices.  With affinity_bias the candidate pool must be
    # larger than the kept set for the bias to have anything to select from.
    needed = num_interactions * (2 if affinity_bias > 0 else 1)
    users = np.empty(0, dtype=np.int64)
    items = np.empty(0, dtype=np.int64)
    oversample = 1.6 * (2 if affinity_bias > 0 else 1)
    for _ in range(8):
        n_draw = int(num_interactions * oversample)
        users = rng.choice(num_users, size=n_draw, p=user_act)
        items = rng.choice(num_items, size=n_draw, p=item_pop)
        keys = users.astype(np.int64) * num_items + items
        _, first_idx = np.unique(keys, return_index=True)
        if len(first_idx) >= needed or n_draw >= 20 * num_interactions:
            break
        oversample *= 2
    first_idx.sort()
    users, items = users[first_idx], items[first_idx]

    if affinity_bias > 0 and len(users) > num_interactions:
        cand_aff = np.einsum('nd,nd->n', user_factors[users],
                             item_factors[items])
        cand_aff = cand_aff / cand_aff.std()
        gumbel = rng.gumbel(size=len(users)).astype(np.float32)
        keep = np.argsort(-(affinity_bias * cand_aff + gumbel))[:num_interactions]
        keep.sort()  # preserve draw order
        users, items = users[keep], items[keep]

    # guarantee every user and every item appears at least once (contiguous IDs,
    # required by the Interactions validation unless allow_missing_ids)
    users = np.concatenate([np.arange(num_users), users])
    items = np.concatenate([rng.integers(0, num_items, size=num_users), items])
    extra_users = rng.integers(0, num_users, size=num_items)
    users = np.concatenate([extra_users, users])
    items = np.concatenate([np.arange(num_items), items])
    keys = users.astype(np.int64) * num_items + items
    _, first_idx = np.unique(keys, return_index=True)
    first_idx.sort()
    users, items = users[first_idx], items[first_idx]
    users = users[:num_interactions]
    items = items[:num_interactions]

    affinity = np.einsum('nd,nd->n', user_factors[users], item_factors[items])
    affinity = affinity / affinity.std()
    score = affinity + noise * rng.standard_normal(len(users)).astype(np.float32)
    # map to 1..5 stars via quantiles resembling the ML-100K rating histogram
    quantiles = np.quantile(score, [0.06, 0.17, 0.44, 0.78])
    ratings = np.digitize(score, quantiles) + 1

    return pd.DataFrame({
        'user_id': users.astype(np.int64),
        'item_id': items.astype(np.int64),
        'rating': ratings.astype(np.int64),
        'timestamp': rng.integers(874_000_000, 893_000_000, size=len(users)),
    })


def generate_implicit_interactions(num_users: int = 943,
                                   num_items: int = 1682,
                                   num_interactions: int = 100_000,
                                   num_negative_samples: int = 10,
                                   min_rating_to_keep: float = 4,
                                   latent_dim: int = 8,
                                   noise: float = 0.25,
                                   affinity_bias: float = 0.0,
                                   seed: int = 42,
                                   **interactions_kwargs) -> 'Interactions':
    """Explicit synthetic data -> implicit ``Interactions`` via the same
    keep->=4-stars conversion the reference applies to MovieLens
    (``utils.py:128-165``, ``run.py:36-38``)."""
    from collie_tpu_torch.data import Interactions
    from collie_tpu_torch.utils import convert_to_implicit

    df = generate_interactions_df(num_users=num_users, num_items=num_items,
                                  num_interactions=num_interactions,
                                  latent_dim=latent_dim, noise=noise,
                                  affinity_bias=affinity_bias, seed=seed)
    df = convert_to_implicit(df, min_rating_to_keep=min_rating_to_keep)
    return Interactions(users=df['user_id'].values,
                        items=df['item_id'].values,
                        ratings=df['rating'].values,
                        num_users=num_users,
                        num_items=num_items,
                        allow_missing_ids=True,
                        num_negative_samples=num_negative_samples,
                        seed=seed,
                        **interactions_kwargs)
