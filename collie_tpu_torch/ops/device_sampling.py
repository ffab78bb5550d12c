"""On-device membership tests against interaction CSRs.

Port of ``pairs_in_csr`` from ``collie_tpu/ops/device_sampling.py:541``; the
negative samplers of that module come with training.  The JAX version runs a
segmented binary search over each user's sorted columns because int32 flat
keys overflow.  PyTorch has int64, so here each CSR entry becomes the flat key
``user << 31 | item`` and one ``torch.searchsorted`` answers the whole batch:
a sorted CSR gives sorted keys, item ids fit in 31 bits, and the answers are
the same.
"""
import torch

_ITEM_BITS = 31


def csr_keys(indptr: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Sorted int64 flat keys of a CSR whose rows have sorted columns."""
    rows = torch.repeat_interleave(
        torch.arange(indptr.numel() - 1, device=cols.device),
        (indptr[1:] - indptr[:-1]).long())
    return (rows << _ITEM_BITS) | cols.long()


def keys_contain(keys: torch.Tensor, user_ids: torch.Tensor,
                 item_ids: torch.Tensor) -> torch.Tensor:
    """Bool ``(user, item) in keys`` of the broadcast shape of the ids."""
    user_ids, item_ids = torch.broadcast_tensors(user_ids, item_ids)
    if keys.numel() == 0:
        return torch.zeros(user_ids.shape, dtype=torch.bool, device=user_ids.device)
    query = (user_ids.long() << _ITEM_BITS) | item_ids.long()
    idx = torch.searchsorted(keys, query.reshape(-1)).clamp_(max=keys.numel() - 1)
    return (keys[idx] == query.reshape(-1)).reshape(query.shape)


def pairs_in_csr(indptr: torch.Tensor,
                 cols: torch.Tensor,
                 user_ids: torch.Tensor,
                 item_ids: torch.Tensor) -> torch.Tensor:
    """Membership test ``(user, item) in csr``.  Shapes broadcast:
    ``user_ids [...]`` x ``item_ids [...]`` -> bool of the broadcast shape.
    Each row's columns must be sorted (``csr.sort_indices()``)."""
    return keys_contain(csr_keys(indptr, cols), user_ids, item_ids)
