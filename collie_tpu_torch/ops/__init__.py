"""Tensor compute: embedding init and dropout, losses, metrics, dense layers,
membership tests, CUDA kernels."""
from collie_tpu_torch.ops.embeddings import (dropout,
                                             embedding_lookup,
                                             scaled_embedding_init,
                                             zero_embedding_init)
from collie_tpu_torch.ops.losses import (adaptive_bpr_loss,
                                         adaptive_hinge_loss,
                                         bpr_loss,
                                         hinge_loss,
                                         ideal_difference_from_metadata,
                                         mae_loss,
                                         mse_loss,
                                         warp_loss)
from collie_tpu_torch.ops.metrics import (auc,
                                          auc_from_scores,
                                          mapk,
                                          mapk_from_scores,
                                          mrr,
                                          mrr_from_scores)

__all__ = [
    'adaptive_bpr_loss', 'adaptive_hinge_loss', 'auc', 'auc_from_scores',
    'bpr_loss', 'dropout', 'embedding_lookup', 'hinge_loss',
    'ideal_difference_from_metadata', 'mae_loss', 'mapk', 'mapk_from_scores',
    'mrr', 'mrr_from_scores', 'mse_loss', 'scaled_embedding_init',
    'warp_loss', 'zero_embedding_init',
]
