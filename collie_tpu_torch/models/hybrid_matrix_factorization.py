"""Multi-stage hybrid recommender with trainable embeddings and metadata towers.

Port of ``collie_tpu/models/hybrid_matrix_factorization.py`` (reference
``collie/model/hybrid_matrix_factorization.py:28-595``).  Stages
(``:43-52``): ``matrix_factorization`` (pure MF, metadata ignored) ->
``metadata_only`` (embeddings frozen; metadata, combined and bias layers
train) -> ``all`` (everything trains).  ``score`` switches on the stage
(``:479-546``): the MF dot product, or the combined MLP over
``concat([user_meta_out], user_emb, item_emb, [item_meta_out])`` plus
biases.  Saving writes a directory with the model and its metadata arrays
(``:558-595``).
"""
from typing import Callable, Dict, List, Optional, Union

import torch

from collie_tpu_torch.models._hybrid_common import (HybridMixin, as_float_array,
                                                    hybrid_pairwise_scores, hybrid_score)
from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT
from collie_tpu_torch.models.multi_stage import MultiStagePipeline
from collie_tpu_torch.ops.embeddings import dropout, embedding_lookup, scaled_embedding_init, \
    tiled_dropout_dots, zero_embedding_init
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


class HybridModel(HybridMixin, MultiStagePipeline):
    """Staged MF + metadata-MLP hybrid.

    Parameters
    ----------
    item_metadata: 2-d array / DataFrame / tensor, ``num_items x features``
    user_metadata: 2-d array / DataFrame / tensor, ``num_users x features``
    embedding_dim: int
    item_metadata_layers_dims / user_metadata_layers_dims: list or None
        Tower widths over the raw metadata before concatenation
    combined_layers_dims: list
        Widths of the combined MLP between the concatenation and the 1-unit
        output layer
    dropout_p: float
    metadata_only_stage_lr / all_stage_lr: float
    metadata_only_stage_optimizer / all_stage_optimizer: str
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 item_metadata=None,
                 user_metadata=None,
                 embedding_dim: int = 30,
                 item_metadata_layers_dims: Optional[List[int]] = None,
                 user_metadata_layers_dims: Optional[List[int]] = None,
                 combined_layers_dims: List[int] = (128, 64, 32),
                 dropout_p: float = 0.0,
                 lr: float = 1e-3,
                 bias_lr: Optional[Union[float, str]] = 1e-2,
                 metadata_only_stage_lr: float = 1e-3,
                 all_stage_lr: float = 1e-4,
                 lr_scheduler_func: Optional[Callable] = _default_scheduler,
                 weight_decay: float = 0.0,
                 optimizer: Union[str, Callable] = 'adam',
                 bias_optimizer: Optional[Union[str, Callable]] = 'sgd',
                 metadata_only_stage_optimizer: Union[str, Callable] = 'adam',
                 all_stage_optimizer: Union[str, Callable] = 'adam',
                 loss: Union[str, Callable] = 'hinge',
                 metadata_for_loss: Optional[Dict] = None,
                 metadata_for_loss_weights: Optional[Dict[str, float]] = None,
                 load_model_path: Optional[str] = None,
                 map_location: Optional[str] = None,
                 **kwargs):
        item_metadata_num_cols = None
        user_metadata_num_cols = None
        optimizer_config_list = None

        self.item_metadata = None
        self.user_metadata = None

        if load_model_path is None:
            if item_metadata is None and user_metadata is None:
                raise ValueError(
                    'Must provide item metadata and/or user metadata for ``HybridModel``.'
                )
            item_metadata = as_float_array(item_metadata)
            user_metadata = as_float_array(user_metadata)
            if item_metadata is not None:
                item_metadata_num_cols = item_metadata.shape[1]
            if user_metadata is not None:
                user_metadata_num_cols = user_metadata.shape[1]

            # stage/optimizer layout mirrors reference ``:204-255``
            if bias_optimizer is not None:
                initial_optimizer_block = [
                    {
                        'lr': lr,
                        'optimizer': optimizer,
                        'parameter_prefix_list': ['user_embedding', 'item_embedding'],
                        'stage': 'matrix_factorization',
                    },
                    {
                        'lr': lr if bias_lr == 'infer' else bias_lr,
                        'optimizer': optimizer if bias_optimizer == 'infer' else bias_optimizer,
                        'parameter_prefix_list': ['user_bias', 'item_bias'],
                        'stage': 'matrix_factorization',
                    },
                ]
            else:
                initial_optimizer_block = [
                    {
                        'lr': lr,
                        'optimizer': optimizer,
                        'parameter_prefix_list': ['user_embedding', 'item_embedding',
                                                  'user_bias', 'item_bias'],
                        'stage': 'matrix_factorization',
                    },
                ]

            optimizer_config_list = initial_optimizer_block + [
                {
                    'lr': metadata_only_stage_lr,
                    'optimizer': metadata_only_stage_optimizer,
                    'parameter_prefix_list': ['item_metadata', 'user_metadata',
                                              'combined', 'user_bias', 'item_bias'],
                    'stage': 'metadata_only',
                },
                {
                    'lr': all_stage_lr,
                    'optimizer': all_stage_optimizer,
                    'parameter_prefix_list': ['user', 'item', 'combined'],
                    'stage': 'all',
                },
            ]

        init_args = get_init_arguments()
        init_args['combined_layers_dims'] = list(combined_layers_dims)
        init_args.pop('item_metadata', None)
        init_args.pop('user_metadata', None)
        super().__init__(optimizer_config_list=optimizer_config_list,
                         item_metadata_num_cols=item_metadata_num_cols,
                         user_metadata_num_cols=user_metadata_num_cols,
                         item_metadata=item_metadata,
                         user_metadata=user_metadata,
                         **init_args)

    __doc__ = merge_docstrings(MultiStagePipeline, __doc__, __init__)

    def _sharded_eval_localizable(self) -> bool:
        # scoring gathers item/user METADATA (non-param arrays) by global id
        return False

    def _setup_model(self, **kwargs) -> None:
        self._install_metadata(**kwargs)
        super()._setup_model(**kwargs)

    def _build_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        num_users = self.hparams['num_users']
        num_items = self.hparams['num_items']
        dim = self.hparams['embedding_dim']
        device = generator.device
        params = {
            'user_embeddings': scaled_embedding_init(generator, num_users, dim),
            'item_embeddings': scaled_embedding_init(generator, num_items, dim),
            'user_biases': zero_embedding_init(num_users, device=device),
            'item_biases': zero_embedding_init(num_items, device=device),
        }

        self._add_metadata_and_combined_params(params, generator, dim * 2)
        return params

    def score(self, params, users, items, training=False, generator=None):
        """The MF dot product in ``matrix_factorization`` (dropout on the
        user rows, then the item rows), the towers and combined MLP after."""
        if self.hparams['stage'] == 'matrix_factorization':
            p = self.hparams.get('dropout_p', 0.0)
            user_emb = dropout(generator, embedding_lookup(params['user_embeddings'], users),
                               p, training)
            item_emb = dropout(generator, embedding_lookup(params['item_embeddings'], items),
                               p, training)
            return ((user_emb * item_emb).sum(dim=1)
                    + params['user_biases'][users] + params['item_biases'][items])
        return hybrid_score(self, params, users, items, training, generator)

    def pairwise_scores(self, params, users, items, training=False, generator=None):
        """Each table gathered once in the ``matrix_factorization`` stage
        (the MF branch of ``score``, dropout masks at ``[R, B, d]``); the
        tile-after-gather combined-MLP path after it
        (``_hybrid_common.hybrid_pairwise_scores``)."""
        if self.hparams['stage'] != 'matrix_factorization':
            return hybrid_pairwise_scores(self, params, users, items, training, generator)
        R, B = items.shape
        user_embeddings = embedding_lookup(params['user_embeddings'], users)
        item_embeddings = embedding_lookup(params['item_embeddings'], items)
        dots = tiled_dropout_dots(user_embeddings, item_embeddings, R, B,
                                  self.hparams.get('dropout_p', 0.0), training, generator)
        return dots + params['user_biases'][users][None, :] + params['item_biases'][items]
