"""Matrix factorization: the flagship model.

Port of ``collie_tpu/models/matrix_factorization.py`` (reference
``collie/model/matrix_factorization.py:12-167``):
``score = dot(user_emb, item_emb) + user_bias + item_bias`` with an optional
``y_range`` sigmoid rescale.  The constructor keeps collie's separate, slower
SGD optimizer settings for the bias terms (``bias_lr=1e-2``,
``bias_optimizer='sgd'``) and the default ``ReduceLROnPlateau(patience=1)``
schedule as hyperparameters.  ``pairwise_scores`` scores the K negatives of
a training batch.  Embedding dropout is not ported yet (training with
``dropout_p > 0`` raises).  Full-catalog and tile scoring are one matmul
each, in full float32 (TF32 stays off).
"""
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, BasePipeline
from collie_tpu_torch.ops.embeddings import embedding_lookup, scaled_embedding_init, \
    zero_embedding_init
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


class MatrixFactorizationModel(BasePipeline):
    """Embedding-dot-product recommender with separate bias optimizer.

    Parameters
    ----------
    embedding_dim: int
        Number of latent factors to use for user and item embeddings
    dropout_p: float
        Probability of dropout on the embeddings
    sparse: bool
        Accepted for API parity; embeddings are dense tables
    bias_lr: float or 'infer'
        Bias terms learning rate. If 'infer', set equal to ``lr``
    bias_optimizer: str or None
        Optimizer for the bias terms ('infer' copies ``optimizer``; None
        merges biases into the single optimizer)
    y_range: tuple
        ``(min, max)`` applies a sigmoid rescale of the output score
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 embedding_dim: int = 30,
                 dropout_p: float = 0.0,
                 sparse: bool = False,
                 lr: float = 1e-3,
                 bias_lr: Optional[Union[float, str]] = 1e-2,
                 lr_scheduler_func: Optional[Callable] = _default_scheduler,
                 weight_decay: float = 0.0,
                 optimizer: Union[str, Callable] = 'adam',
                 bias_optimizer: Optional[Union[str, Callable]] = 'sgd',
                 loss: Union[str, Callable] = 'hinge',
                 metadata_for_loss: Optional[Dict] = None,
                 metadata_for_loss_weights: Optional[Dict[str, float]] = None,
                 y_range: Optional[Tuple[float, float]] = None,
                 load_model_path: Optional[str] = None,
                 map_location: Optional[str] = None,
                 **kwargs):
        super().__init__(**get_init_arguments())

    __doc__ = merge_docstrings(BasePipeline, __doc__, __init__)

    def _build_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        num_users = self.hparams['num_users']
        num_items = self.hparams['num_items']
        dim = self.hparams['embedding_dim']
        return {
            'user_embeddings': scaled_embedding_init(generator, num_users, dim),
            'item_embeddings': scaled_embedding_init(generator, num_items, dim),
            'user_biases': zero_embedding_init(num_users, device=generator.device),
            'item_biases': zero_embedding_init(num_items, device=generator.device),
        }

    def score(self, params, users, items):
        preds = ((embedding_lookup(params['user_embeddings'], users)
                  * embedding_lookup(params['item_embeddings'], items)).sum(dim=1)
                 + params['user_biases'][users] + params['item_biases'][items])
        return self._apply_y_range(preds)

    def pairwise_scores(self, params, users, items):
        """Scores ``[R, B]`` of users ``[B]`` against item ids ``[R, B]``: user
        rows gathered once, item rows ``[R, B, d]`` once."""
        user_emb = embedding_lookup(params['user_embeddings'], users)
        item_emb = embedding_lookup(params['item_embeddings'], items)
        preds = ((user_emb[None] * item_emb).sum(dim=-1)
                 + params['user_biases'][users][None, :] + params['item_biases'][items])
        return self._apply_y_range(preds)

    def _apply_y_range(self, preds):
        y_range = self.hparams.get('y_range')
        if y_range is not None:
            preds = torch.sigmoid(preds) * (y_range[1] - y_range[0]) + y_range[0]
        return preds

    def score_all_items(self, params, user_ids):
        """Full-catalog scoring as one matmul:
        ``[B, d] x [d, num_items] + biases``."""
        user_emb = embedding_lookup(params['user_embeddings'], user_ids)
        preds = (user_emb @ params['item_embeddings'].float().T
                 + params['user_biases'][user_ids][:, None]
                 + params['item_biases'][None, :])
        return self._apply_y_range(preds)

    def score_item_block(self, params, user_ids, item_ids):
        """One matmul per (user batch x item tile) for blockwise retrieval."""
        user_emb = embedding_lookup(params['user_embeddings'], user_ids)
        item_emb = embedding_lookup(params['item_embeddings'], item_ids)
        preds = (user_emb @ item_emb.T
                 + params['user_biases'][user_ids][:, None]
                 + params['item_biases'][item_ids][None, :])
        return self._apply_y_range(preds)

    def _get_item_embeddings(self) -> torch.Tensor:
        return self.params['item_embeddings']

    def _get_user_embeddings(self) -> torch.Tensor:
        return self.params['user_embeddings']
