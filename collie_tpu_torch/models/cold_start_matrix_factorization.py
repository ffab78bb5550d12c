"""Cold-start matrix factorization via item buckets.

Port of ``collie_tpu/models/cold_start_matrix_factorization.py`` (reference
``collie/model/cold_start_matrix_factorization.py:21-367``).  Two stages:

1. ``item_buckets``: MF where item ids map through the ``item_buckets``
   lookup onto shared bucket embeddings/biases (``:304-309``);
2. ``no_buckets``: per-item MF.  On the transition the per-item tables
   become a copy of the bucket rows gathered by ``item_buckets``
   (``:217-239``), installed as new parameters.

``item_bucket_item_similarity`` scores all items against a bucket embedding
(``:322-359``); bucket validation mirrors ``:192-204``.
"""
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import pandas as pd
import torch

from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, _whole_tables
from collie_tpu_torch.models.multi_stage import MultiStagePipeline
from collie_tpu_torch.ops.embeddings import dropout, scaled_embedding_init, tiled_dropout_dots, \
    zero_embedding_init
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


class ColdStartModel(MultiStagePipeline):
    """Bucketed-then-per-item MF for cold-start items.

    Parameters
    ----------
    item_buckets: iterable of int
        Bucket ID for each item ID (length ``num_items``, 0-based)
    embedding_dim: int
    dropout_p: float
    item_buckets_stage_lr / no_buckets_stage_lr: float
    item_buckets_stage_optimizer / no_buckets_stage_optimizer: str
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 item_buckets: Optional[Iterable[int]] = None,
                 embedding_dim: int = 30,
                 dropout_p: float = 0.0,
                 sparse: bool = False,
                 item_buckets_stage_lr: float = 1e-3,
                 no_buckets_stage_lr: float = 1e-3,
                 lr_scheduler_func: Optional[Callable] = _default_scheduler,
                 weight_decay: float = 0.0,
                 item_buckets_stage_optimizer: Union[str, Callable] = 'adam',
                 no_buckets_stage_optimizer: Union[str, Callable] = 'adam',
                 loss: Union[str, Callable] = 'hinge',
                 metadata_for_loss: Optional[Dict] = None,
                 metadata_for_loss_weights: Optional[Dict[str, float]] = None,
                 load_model_path: Optional[str] = None,
                 map_location: Optional[str] = None,
                 **kwargs):
        optimizer_config_list = None
        num_item_buckets = None

        if load_model_path is None:
            optimizer_config_list = [
                {
                    'lr': item_buckets_stage_lr,
                    'optimizer': item_buckets_stage_optimizer,
                    'parameter_prefix_list': [
                        'user_embed', 'user_bias', 'item_bucket_embed', 'item_bucket_bias',
                    ],
                    'stage': 'item_buckets',
                },
                {
                    'lr': no_buckets_stage_lr,
                    'optimizer': no_buckets_stage_optimizer,
                    'parameter_prefix_list': [
                        'user_embed', 'user_bias', 'item_embed', 'item_bias',
                    ],
                    'stage': 'no_buckets',
                },
            ]

            item_buckets = np.asarray(item_buckets)
            if item_buckets.ndim != 1:
                # the JAX package's exception type (an ``assert`` there)
                raise AssertionError(
                    f'``item_buckets`` must be 1-dimensional, not {item_buckets.ndim}-dimensional!'
                )
            num_items = train.num_items
            if len(item_buckets) != num_items:
                raise ValueError(
                    'Length of ``item_buckets`` must be equal to the number of items in the '
                    f'dataset: {len(item_buckets)} != {num_items}.'
                )
            if item_buckets.min() != 0:
                raise ValueError(
                    f'``item_buckets`` IDs must start at 0, not {item_buckets.min()}!'
                )
            num_item_buckets = int(item_buckets.max()) + 1
            item_buckets = item_buckets.astype(np.int32).tolist()  # JSON-safe hparam

        init_args = get_init_arguments()
        init_args['item_buckets'] = item_buckets
        super().__init__(optimizer_config_list=optimizer_config_list,
                         num_item_buckets=num_item_buckets,
                         **init_args)

    __doc__ = merge_docstrings(MultiStagePipeline, __doc__, __init__)

    def _install_item_buckets(self) -> None:
        """The bucket of each item id, as an int64 tensor on the model's device."""
        self._item_buckets_device = torch.as_tensor(
            np.asarray(self.hparams['item_buckets'], dtype=np.int64), device=self._device)

    def _sharded_eval_localizable(self) -> bool:
        # the bucket stage maps item ids through the ``item_buckets``
        # constant; only the final per-item stage is pure table gathers
        return self.current_stage == 'no_buckets'

    def _setup_model(self, **kwargs) -> None:
        self._install_item_buckets()
        super()._setup_model(**kwargs)

    def _load_model_init_helper(self, *args, **kwargs) -> None:
        super()._load_model_init_helper(*args, **kwargs)
        self._install_item_buckets()

    def _build_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        num_users = self.hparams['num_users']
        num_items = self.hparams['num_items']
        num_buckets = self.hparams['num_item_buckets']
        dim = self.hparams['embedding_dim']
        device = generator.device
        return {
            'user_embeddings': scaled_embedding_init(generator, num_users, dim),
            'item_embeddings': scaled_embedding_init(generator, num_items, dim),
            'item_bucket_embeddings': scaled_embedding_init(generator, num_buckets, dim),
            'user_biases': zero_embedding_init(num_users, device=device),
            'item_biases': zero_embedding_init(num_items, device=device),
            'item_bucket_biases': zero_embedding_init(num_buckets, device=device),
        }

    def set_stage(self, stage: str) -> None:
        """On the bucket -> item transition, the per-item tables become a
        copy of the bucket rows gathered by ``item_buckets`` (reference
        ``:217-239``), installed as new parameters."""
        current_stage = self.hparams.get('stage')
        if stage not in self.hparams['stage_list']:
            raise ValueError(
                f'"{stage}" is not a valid stage, please choose one of '
                f'{self.hparams["stage_list"]}'
            )
        if current_stage == 'item_buckets' and stage == 'no_buckets':
            print('Copying over item embeddings...')
            params = self.params
            buckets = self._item_buckets_device
            layout = self.param_layout()
            if layout is None:
                self.load_params({
                    **params,
                    'item_embeddings': params['item_bucket_embeddings'][buckets],
                    'item_biases': params['item_bucket_biases'][buckets],
                })
            else:
                # a model holding shards fills each rank's item-row shard
                # from the (possibly sharded) bucket table by the sharded
                # lookup; no rank gathers a whole table
                from collie_tpu_torch.parallel.embedding import lookup_for_shards

                mesh, specs = layout
                self.load_shards({**params, **{
                    target: lookup_for_shards(params[source], bool(specs[source]), buckets,
                                              bool(specs[target]), mesh)
                    for target, source in (('item_embeddings', 'item_bucket_embeddings'),
                                           ('item_biases', 'item_bucket_biases'))}},
                    mesh, specs)
        super().set_stage(stage)

    # the fused [*, D+1] layout of the generic epoch: all three
    # (embeddings, biases) pairs; the stage-gated specs update the named
    # slices of the active stage, and the other tables ride through
    _FUSED_TABLE_SPEC = (
        ('user_embeddings', 'user_biases', 'user_fused'),
        ('item_embeddings', 'item_biases', 'item_fused'),
        ('item_bucket_embeddings', 'item_bucket_biases', 'item_bucket_fused'),
    )

    def supports_fused_tables(self) -> bool:
        return self._fused_tables_ok(ColdStartModel)

    def _item_lookup(self, params, items):
        """Stage-conditional item rows and biases under either layout:
        ``item_buckets`` maps ids through the bucket assignment (clamped
        into the item range) first."""
        if self.hparams['stage'] == 'item_buckets':
            buckets = self._item_buckets_device
            mapped = buckets[items.clamp(0, buckets.shape[0] - 1)]
            return self._emb_bias_lookup(params, 'item_bucket_embeddings',
                                         'item_bucket_biases', 'item_bucket_fused', mapped)
        return self._emb_bias_lookup(params, 'item_embeddings', 'item_biases', 'item_fused',
                                     items)

    def score(self, params, users, items, training=False, generator=None):
        user_embeddings, user_biases = self._emb_bias_lookup(
            params, 'user_embeddings', 'user_biases', 'user_fused', users)
        item_embeddings, item_biases = self._item_lookup(params, items)
        p = self.hparams.get('dropout_p', 0.0)
        user_embeddings = dropout(generator, user_embeddings, p, training)
        item_embeddings = dropout(generator, item_embeddings, p, training)
        return (user_embeddings * item_embeddings).sum(dim=1) + user_biases + item_biases

    def pairwise_scores(self, params, users, items, training=False, generator=None):
        """Scores ``[R, B]`` of users ``[B]`` against item ids ``[R, B]``,
        each table gathered once, with the stage-conditional item source;
        dropout masks at ``[R, B, d]`` (``tiled_dropout_dots``)."""
        R, B = items.shape
        user_embeddings, user_b = self._emb_bias_lookup(
            params, 'user_embeddings', 'user_biases', 'user_fused', users)
        item_embeddings, item_biases = self._item_lookup(params, items)
        dots = tiled_dropout_dots(user_embeddings, item_embeddings, R, B,
                                  self.hparams.get('dropout_p', 0.0), training, generator)
        return dots + user_b[None, :] + item_biases

    @_whole_tables
    def item_bucket_item_similarity(self, item_bucket_id: int) -> pd.Series:
        """Cosine similarity of one bucket embedding against every item
        embedding (reference ``:322-359``)."""
        bucket_emb = self.params['item_bucket_embeddings'].float()
        bucket_emb = bucket_emb / torch.linalg.norm(bucket_emb, dim=1, keepdim=True)
        item_emb = self._get_item_embeddings().float()
        item_emb = item_emb / torch.linalg.norm(item_emb, dim=1, keepdim=True)
        sims = bucket_emb[item_bucket_id] @ item_emb.T
        return pd.Series(sims.cpu().numpy()).sort_values(ascending=False)

    def _get_item_embeddings(self) -> torch.Tensor:
        return self.params['item_embeddings']

    def _get_user_embeddings(self) -> torch.Tensor:
        return self.params['user_embeddings']
