"""Collaborative metric learning.

Port of ``collie_tpu/models/collaborative_metric_learning.py`` (reference
``collie/model/collaborative_metric_learning.py:12-132``), per
arXiv:1803.00202: ``score = pairwise_distance(user_emb, item_emb)``, the
euclidean distance with torch's ``eps=1e-6`` added to the difference; no
bias terms, single optimizer.  As in the reference, the accepted
``y_range`` hyperparameter is not applied by the forward pass
(``:100-124``).
"""
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, BasePipeline
from collie_tpu_torch.ops.embeddings import embedding_lookup, scaled_embedding_init
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


def _distance(user_embeddings, item_embeddings):
    """``||u - i + 1e-6||_2`` over the last dim
    (``torch.nn.functional.pairwise_distance`` semantics)."""
    diff = user_embeddings - item_embeddings + 1e-6
    return diff.square().sum(dim=-1).sqrt()


class CollaborativeMetricLearningModel(BasePipeline):
    """Metric-space recommender: score is the user-item embedding distance.

    Parameters
    ----------
    embedding_dim: int
    sparse: bool
        Accepted for API parity; embeddings are dense tables
    y_range: tuple
        Accepted for parity; not applied by the forward pass (as in the
        reference)
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 embedding_dim: int = 30,
                 sparse: bool = False,
                 lr: float = 1e-3,
                 lr_scheduler_func: Optional[Callable] = _default_scheduler,
                 weight_decay: float = 0.0,
                 optimizer: Union[str, Callable] = 'adam',
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
        dim = self.hparams['embedding_dim']
        return {
            'user_embeddings': scaled_embedding_init(generator, self.hparams['num_users'], dim),
            'item_embeddings': scaled_embedding_init(generator, self.hparams['num_items'], dim),
        }

    def score(self, params, users, items, training=False, generator=None):
        return _distance(embedding_lookup(params['user_embeddings'], users),
                         embedding_lookup(params['item_embeddings'], items))

    def pairwise_scores(self, params, users, items, training=False, generator=None):
        """User rows gathered once ``[B, d]`` and broadcast against the
        ``[R, B, d]`` item rows."""
        return _distance(embedding_lookup(params['user_embeddings'], users)[None],
                         embedding_lookup(params['item_embeddings'], items))

    def _get_item_embeddings(self) -> torch.Tensor:
        return self.params['item_embeddings']

    def _get_user_embeddings(self) -> torch.Tensor:
        return self.params['user_embeddings']
