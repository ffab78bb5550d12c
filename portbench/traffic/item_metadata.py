"""Item metadata in the form of MovieLens-20M's, made on the card from the
seed: the Tag Genome's relevances and the genres' multi-hot columns.

Neither file is read (a run may not fetch them).  The values carry the
signal the log was drawn from: ``planted_item_factors`` draws again the
latent item factors that ``traffic/ratings.py`` plants for the same seed
(the generator's first two draws, users' then items'), and

* a genome movie's relevance to a tag is
  ``sigmoid(logit_mean + offset_t + factor_weight * f_i . w_t / sqrt(d)
  + noise * e_it)``, in [0, 1], with ``f_i`` the item's planted factors,
  ``w_t ~ N(0, I_d)`` a tag's loadings, ``offset_t ~ N(0, tag_offset_std)``
  and ``e_it ~ N(0, 1)``: most relevances are low, as in the Tag Genome,
  and items near in the planted space have near relevance rows;
* the ``genome_movies`` most-rated items of the log (ties to the lower id)
  hold genome rows, the rest zero rows, as the Tag Genome covers the
  10,381 movies with enough tags of ML-20M's 26,744;
* every movie draws 1 to 3 genres, uniformly, the ones with the largest
  ``f_i . g_c / sqrt(d) + Gumbel noise`` over the genres' loadings ``g_c``.

Columns: the genome's tags, then the genres.
"""
from typing import Dict

import torch


def planted_item_factors(num_users: int, num_items: int, seed: int, device,
                         latent_dim: int) -> torch.Tensor:
    """The ``[num_items, latent_dim]`` item factors ``generate_ratings``
    draws for ``seed`` on ``device``: the same generator, seed and draws."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    torch.randn(num_users, latent_dim, generator=g, device=device)
    return torch.randn(num_items, latent_dim, generator=g, device=device)


def item_metadata(items: torch.Tensor, factors: torch.Tensor, spec: Dict,
                  generator: torch.Generator) -> torch.Tensor:
    """``[num_items, genome_tags + genres]`` float32 on the generator's
    device, from the log's item ids ``items`` (one per rating), the planted
    ``factors`` and the configuration's ``item_metadata`` block ``spec``."""
    device = generator.device
    num_items, d = factors.shape
    tags, genres = spec['genome_tags'], spec['genres']
    scale = d ** -0.5
    counts = torch.bincount(items.to(device), minlength=num_items)
    genome_items = torch.sort(-counts, stable=True).indices[:spec['genome_movies']]
    loadings = torch.randn(d, tags, generator=generator, device=device)
    offsets = spec['tag_offset_std'] * torch.randn(tags, generator=generator, device=device)
    noise = torch.randn(genome_items.numel(), tags, generator=generator, device=device)
    logits = (spec['logit_mean'] + offsets
              + spec['factor_weight'] * scale * (factors[genome_items] @ loadings)
              + spec['noise'] * noise)
    out = torch.zeros(num_items, tags + genres, device=device)
    out[genome_items, :tags] = torch.sigmoid(logits)
    lo, hi = spec['genres_per_movie']
    genre_loadings = torch.randn(d, genres, generator=generator, device=device)
    u01 = torch.rand(num_items, genres, generator=generator, device=device)
    gumbel = -torch.log(-torch.log(u01.clamp(1e-12, 1 - 1e-7)))
    order = torch.argsort(scale * (factors @ genre_loadings) + gumbel, dim=1, descending=True)
    held = torch.randint(lo, hi + 1, (num_items, 1), generator=generator, device=device)
    chosen = torch.arange(genres, device=device)[None] < held              # by rank
    out[:, tags:].scatter_(1, order, chosen.to(out.dtype))
    return out
