"""Embedding-table initializers and lookup helpers.

Port of ``collie_tpu/ops/embeddings.py``: ``ScaledEmbedding`` (normal with
std ``1 / (embedding_dim * 2.5)``) and ``ZeroEmbedding`` (zeroed bias tables)
of the reference's ``layers.py:6-17``, as plain tensors plus a lookup.  The
draws come from an explicit ``torch.Generator``; they are not JAX's draws
for the same seed, so parity tests copy params across instead.
"""
from typing import Optional, Tuple

import torch


def scaled_embedding_init(generator: torch.Generator,
                          num_embeddings: int,
                          embedding_dim: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, 1 / (embedding_dim * 2.5)) init on the generator's device."""
    std = 1.0 / (embedding_dim * 2.5)
    return std * torch.randn((num_embeddings, embedding_dim), generator=generator,
                             dtype=dtype, device=generator.device)


def zero_embedding_init(num_embeddings: int,
                        embedding_dim: Optional[int] = None,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> torch.Tensor:
    """Zero-initialized table for bias terms; ``embedding_dim=None`` gives a
    1-d bias vector."""
    shape: Tuple[int, ...] = (num_embeddings,) if embedding_dim is None \
        else (num_embeddings, embedding_dim)
    return torch.zeros(shape, dtype=dtype, device=device)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather, upcast to float32 right after it: bfloat16 tables
    (``embeddings_dtype='bfloat16'``) read half-width rows and every score
    downstream computes in float32."""
    return table[ids].float()
