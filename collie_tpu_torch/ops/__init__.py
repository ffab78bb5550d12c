"""Tensor compute: embedding init, metrics, membership tests, CUDA kernels."""
from collie_tpu_torch.ops.embeddings import (embedding_lookup,
                                             scaled_embedding_init,
                                             zero_embedding_init)
from collie_tpu_torch.ops.metrics import (auc,
                                          auc_from_scores,
                                          mapk,
                                          mapk_from_scores,
                                          mrr,
                                          mrr_from_scores)

__all__ = [
    'auc', 'auc_from_scores', 'embedding_lookup', 'mapk', 'mapk_from_scores',
    'mrr', 'mrr_from_scores', 'scaled_embedding_init', 'zero_embedding_init',
]
