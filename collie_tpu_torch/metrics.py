"""Import-path parity module: ``collie_tpu_torch.metrics`` mirrors ``collie.metrics``
(reference ``collie/metrics.py``)."""
from collie_tpu_torch.evaluate import (evaluate_in_batches,
                                       explicit_evaluate_in_batches,
                                       get_preds)
from collie_tpu_torch.ops.metrics import (auc,
                                          auc_from_scores,
                                          mapk,
                                          mapk_from_scores,
                                          mrr,
                                          mrr_from_scores)

__all__ = [
    'auc', 'auc_from_scores', 'evaluate_in_batches', 'explicit_evaluate_in_batches',
    'get_preds', 'mapk', 'mapk_from_scores', 'mrr', 'mrr_from_scores',
]
