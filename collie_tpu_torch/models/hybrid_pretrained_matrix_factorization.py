"""Hybrid recommender seeded from a trained ``MatrixFactorizationModel``.

Port of ``collie_tpu/models/hybrid_pretrained_matrix_factorization.py``
(reference ``collie/model/hybrid_pretrained_matrix_factorization.py:23-555``):
the metadata-tower + combined-MLP architecture of ``HybridModel``, with the
user/item embeddings and biases copied from a trained MF model of this
package (``:241-250``), never aliased, and optionally frozen
(``:476-484``).  Single-stage.  The donor's table shapes are recorded in the
hparams, so a load rebuilds the model without it.  Saving writes a
directory that leaves the donor out (``:486-534``);
``load_from_hybrid_model`` copies hparams and weights from another instance
(``:536-555``).
"""
from typing import Callable, Dict, List, Optional, Union

import torch

from collie_tpu_torch.models._hybrid_common import (HybridMixin, as_float_array,
                                                    hybrid_pairwise_scores, hybrid_score,
                                                    metadata_tensor)
from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, BasePipeline
from collie_tpu_torch.ops.embeddings import scaled_embedding_init, zero_embedding_init
from collie_tpu_torch.training.optimizers import OptimizerSpec, build_transform
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings

_DONOR_KEYS = ('user_embeddings', 'item_embeddings', 'user_biases', 'item_biases')


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


class HybridPretrainedModel(HybridMixin, BasePipeline):
    """Metadata hybrid on top of pretrained MF embeddings.

    Parameters
    ----------
    trained_model: MatrixFactorizationModel
        Trained donor whose embeddings/biases are copied (never mutated)
    item_metadata / user_metadata: 2-d array / DataFrame / tensor
    item_metadata_layers_dims / user_metadata_layers_dims: list or None
    combined_layers_dims: list
    freeze_embeddings: bool
        Freeze the copied embeddings (biases stay trainable, as in the
        reference)
    dropout_p: float
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 item_metadata=None,
                 user_metadata=None,
                 trained_model=None,
                 item_metadata_layers_dims: Optional[List[int]] = None,
                 user_metadata_layers_dims: Optional[List[int]] = None,
                 combined_layers_dims: List[int] = (128, 64, 32),
                 freeze_embeddings: bool = True,
                 dropout_p: float = 0.0,
                 lr: float = 1e-3,
                 lr_scheduler_func: Optional[Callable] = _default_scheduler,
                 weight_decay: float = 0.0,
                 optimizer: Union[str, Callable] = 'adam',
                 loss: Union[str, Callable] = 'hinge',
                 metadata_for_loss: Optional[Dict] = None,
                 metadata_for_loss_weights: Optional[Dict[str, float]] = None,
                 load_model_path: Optional[str] = None,
                 map_location: Optional[str] = None,
                 **kwargs):
        item_metadata_num_cols = None
        user_metadata_num_cols = None

        self.item_metadata = None
        self.user_metadata = None
        self._embeddings_frozen = bool(freeze_embeddings)

        if load_model_path is None:
            if trained_model is None:
                raise ValueError('Must provide ``trained_model`` for ``HybridPretrainedModel``.')
            if item_metadata is None and user_metadata is None:
                raise ValueError(
                    'Must provide item metadata and/or user_metadata for '
                    '``HybridPretrainedModel``.'
                )
            item_metadata = as_float_array(item_metadata)
            user_metadata = as_float_array(user_metadata)
            if item_metadata is not None:
                item_metadata_num_cols = item_metadata.shape[1]
            if user_metadata is not None:
                user_metadata_num_cols = user_metadata.shape[1]

        init_args = get_init_arguments()
        init_args['combined_layers_dims'] = list(combined_layers_dims)
        for consumed in ('item_metadata', 'user_metadata', 'trained_model'):
            init_args.pop(consumed, None)
        # the donor reaches ``_setup_model`` as a keyword and is not kept:
        # an attribute would register it as a submodule of this model
        super().__init__(item_metadata_num_cols=item_metadata_num_cols,
                         user_metadata_num_cols=user_metadata_num_cols,
                         item_metadata=item_metadata,
                         user_metadata=user_metadata,
                         trained_model=trained_model,
                         **init_args)

    __doc__ = merge_docstrings(BasePipeline, __doc__, __init__)

    def _sharded_eval_localizable(self) -> bool:
        # scoring gathers item/user METADATA (non-param arrays) by global id
        return False

    def _setup_model(self, trained_model, **kwargs) -> None:
        self._install_metadata(**kwargs)
        donor = trained_model.whole_params()     # a donor fit on a mesh holds shards
        # record the donor's dims so a load can rebuild the tables (``:256-260``)
        self.hparams['user_num_embeddings'] = donor['user_embeddings'].shape[0]
        self.hparams['user_embeddings_dim'] = donor['user_embeddings'].shape[1]
        self.hparams['item_num_embeddings'] = donor['item_embeddings'].shape[0]
        self.hparams['item_embeddings_dim'] = donor['item_embeddings'].shape[1]
        super()._setup_model(**kwargs)
        # copy, never alias, the donor's weights (``:241-250``)
        self.load_params({**self.params,
                          **{k: donor[k].detach().clone() for k in _DONOR_KEYS}})

    def _build_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        user_n = self.hparams['user_num_embeddings']
        user_d = self.hparams['user_embeddings_dim']
        item_n = self.hparams['item_num_embeddings']
        item_d = self.hparams['item_embeddings_dim']
        device = generator.device
        params = {
            # placeholders, replaced by the donor's copy or the loaded weights
            'user_embeddings': scaled_embedding_init(generator, user_n, user_d),
            'item_embeddings': scaled_embedding_init(generator, item_n, item_d),
            'user_biases': zero_embedding_init(user_n, device=device),
            'item_biases': zero_embedding_init(item_n, device=device),
        }

        self._add_metadata_and_combined_params(params, generator, user_d + item_d)
        return params

    def score(self, params, users, items, training=False, generator=None):
        """Towers, combined MLP and biases; frozen embedding rows get no
        gradient (the reference's ``requires_grad = False``)."""
        return hybrid_score(self, params, users, items, training, generator,
                            detach_embeddings=self._embeddings_frozen)

    def pairwise_scores(self, params, users, items, training=False, generator=None):
        """The tile-after-gather combined-MLP path
        (``_hybrid_common.hybrid_pairwise_scores``), with ``score``'s
        frozen-embedding semantics."""
        return hybrid_pairwise_scores(self, params, users, items, training, generator,
                                      detach_embeddings=self._embeddings_frozen)

    def freeze_embeddings(self) -> None:
        """Stop optimizing the copied embedding tables (reference ``:476-479``)."""
        self._embeddings_frozen = True

    def unfreeze_embeddings(self) -> None:
        """Resume optimizing the copied embedding tables (reference ``:481-484``)."""
        self._embeddings_frozen = False

    def optimizer_specs(self) -> List[OptimizerSpec]:
        """One optimizer over every param; frozen embedding tables are left
        out of it."""
        keys = sorted(self.params.keys())
        if self._embeddings_frozen:
            keys = [k for k in keys if k not in ('user_embeddings', 'item_embeddings')]
        return [OptimizerSpec(
            name='all',
            transform=build_transform(self.optimizer, self.hparams['lr'],
                                      self.hparams.get('weight_decay', 0.0)),
            keys=keys)]

    def load_from_hybrid_model(self, hybrid_model: 'HybridPretrainedModel') -> None:
        """Copy hparams and weights from another instance (reference ``:536-555``)."""
        for key, value in hybrid_model.hparams.items():
            self.hparams[key] = value
        self.item_metadata = metadata_tensor(hybrid_model.item_metadata, self._device)
        self.user_metadata = metadata_tensor(hybrid_model.user_metadata, self._device)
        self.load_params({k: v.clone() for k, v in hybrid_model.params.items()})
