"""Embedding-table initializers and lookup helpers.

Port of ``collie_tpu/ops/embeddings.py``: ``ScaledEmbedding`` (normal with
std ``1 / (embedding_dim * 2.5)``) and ``ZeroEmbedding`` (zeroed bias tables)
of the reference's ``layers.py:6-17``, as plain tensors plus a lookup, and
the embedding dropout of the reference's ``matrix_factorization.py:130-138``.
The draws come from an explicit ``torch.Generator``; they are not JAX's
draws for the same seed, so parity tests copy params across instead, and
hand ``dropout_mask`` JAX's masks.
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
    downstream computes in float32.  A bfloat16 table's gradient sums the
    rows' float32 gradients in float32 and rounds to bfloat16 once
    (``_Bf16Lookup``), as the reference's ``_bf16_lookup`` does: popular
    rows collide many times a batch, and summing the collisions in bfloat16
    rounds most of the signal away.

    A mesh training step hands the models its tables as
    ``parallel.embedding.ShardedTable`` objects, whose own ``lookup`` is
    the sharded one."""
    if not isinstance(table, torch.Tensor):
        return table.lookup(ids)
    if table.dtype == torch.bfloat16:
        return _Bf16Lookup.apply(table, ids)
    return table[ids].float()


class _Bf16Lookup(torch.autograd.Function):
    """``table[ids].float()`` for a bfloat16 table, whose backward
    accumulates into a float32 table and casts to bfloat16 once.  The
    accumulation is ``index_put_(accumulate=True)``, which on CUDA sums in
    one sorted order, so the gradient does not depend on atomics."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table[ids].float()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        ids, = ctx.saved_tensors
        acc = torch.zeros(ctx.table_shape, dtype=torch.float32, device=grad.device)
        acc.index_put_((ids,), grad.float(), accumulate=True)
        return acc.to(torch.bfloat16), None


def dropout_mask(generator: torch.Generator, shape, keep: float) -> torch.Tensor:
    """Boolean keep-mask of ``shape``, each element kept with probability
    ``keep``, drawn from ``generator`` on its device.  Every dropout mask of
    the port is drawn here, in the JAX package's order and at its shapes, so
    a test can hand this function JAX's masks instead."""
    return torch.rand(shape, generator=generator, device=generator.device) < keep


def dropout(generator: Optional[torch.Generator],
            x: torch.Tensor,
            rate: float,
            training: bool) -> torch.Tensor:
    """Inverted dropout (``torch.nn.Dropout`` semantics): kept elements
    scaled by ``1 / (1 - rate)``, dropped ones zero.  The identity outside
    training, at ``rate <= 0`` or without a generator."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(generator, x.shape, keep)
    return torch.where(mask, x / keep, 0.0)


def tiled_dropout_dots(user_embeddings: torch.Tensor,
                       item_embeddings: torch.Tensor,
                       R: int,
                       B: int,
                       rate: float,
                       training: bool,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """``[R, B]`` dot products between ``[B, d]`` user rows and ``[R, B, d]``
    item rows, the core of the table models' ``pairwise_scores``.

    Under dropout the user rows are broadcast to ``[R, B, d]`` and masked,
    then the item rows, both masks drawn at the ``[R, B, d]`` shape: the
    draws fill row-major over the same element count, so they equal the
    base hook's tiled ``[R*B, d]`` masks element for element."""
    if training and rate and generator is not None:
        dim = user_embeddings.shape[1]
        tiled = dropout(generator, user_embeddings[None].expand(R, B, dim), rate, training)
        item_embeddings = dropout(generator, item_embeddings, rate, training)
        return (tiled * item_embeddings).sum(dim=-1)
    return (user_embeddings[None] * item_embeddings).sum(dim=-1)


def split_generator(generator: Optional[torch.Generator]):
    """Two independent generators on ``generator``'s device, seeded from
    draws of ``generator`` (the analog of ``jax.random.split``); ``None``
    splits into two ``None``s."""
    if generator is None:
        return None, None
    seeds = torch.randint(0, 2 ** 62, (2,), generator=generator,
                          device=generator.device).tolist()
    children = []
    for seed in seeds:
        child = torch.Generator(device=generator.device)
        child.manual_seed(int(seed))
        children.append(child)
    return tuple(children)
