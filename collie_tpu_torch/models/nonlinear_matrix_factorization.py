"""Nonlinear matrix factorization with user/item dense towers.

Port of ``collie_tpu/models/nonlinear_matrix_factorization.py`` (reference
``collie/model/nonlinear_matrix_factorization.py:13-244``): separate
leaky-ReLU dense towers transform the user and item embeddings, then
``dot(tower(user), tower(item)) + biases`` with separate embedding and dense
dropout.  Similarity embeddings are the *post-tower* outputs (``:214-244``),
cached until the params change.
"""
import weakref
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, BasePipeline
from collie_tpu_torch.ops.embeddings import dropout, embedding_lookup, \
    scaled_embedding_init, zero_embedding_init
from collie_tpu_torch.ops.nn import add_linear, leaky_relu, linear
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


class NonlinearMatrixFactorizationModel(BasePipeline):
    """MF with dense towers over each embedding before the dot product.

    Parameters
    ----------
    user_embedding_dim: int
    item_embedding_dim: int
    user_dense_layers_dims: list
        Tower widths applied to the user embedding
    item_dense_layers_dims: list
        Tower widths applied to the item embedding
    embedding_dropout_p: float
        Dropout on the tower outputs before the dot product
    dense_dropout_p: float
        Dropout between tower layers
    bias_lr: float or 'infer'
    bias_optimizer: str or None
    y_range: tuple
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 user_embedding_dim: int = 60,
                 item_embedding_dim: int = 60,
                 user_dense_layers_dims: List[int] = (48, 32),
                 item_dense_layers_dims: List[int] = (48, 32),
                 embedding_dropout_p: float = 0.0,
                 dense_dropout_p: float = 0.0,
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
        init_args = get_init_arguments()
        init_args['user_dense_layers_dims'] = list(user_dense_layers_dims)
        init_args['item_dense_layers_dims'] = list(item_dense_layers_dims)
        super().__init__(**init_args)

    __doc__ = merge_docstrings(BasePipeline, __doc__, __init__)

    def _build_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        num_users = self.hparams['num_users']
        num_items = self.hparams['num_items']
        device = generator.device
        params = {
            'user_embeddings': scaled_embedding_init(
                generator, num_users, self.hparams['user_embedding_dim']),
            'item_embeddings': scaled_embedding_init(
                generator, num_items, self.hparams['item_embedding_dim']),
            'user_biases': zero_embedding_init(num_users, device=device),
            'item_biases': zero_embedding_init(num_items, device=device),
        }
        for kind in ('user', 'item'):
            dims = [self.hparams[f'{kind}_embedding_dim']] + \
                list(self.hparams[f'{kind}_dense_layers_dims'])
            for i in range(len(dims) - 1):
                add_linear(params, f'{kind}_dense_{i}', generator, dims[i], dims[i + 1],
                           init='xavier_normal')
        return params

    def _tower(self, params, kind: str, x, training, generator):
        """``kind``'s dense tower: leaky ReLU after every layer, dense
        dropout between layers (one draw per layer, in layer order)."""
        dense_p = self.hparams.get('dense_dropout_p', 0.0)
        n_layers = len(self.hparams[f'{kind}_dense_layers_dims'])
        for i in range(n_layers):
            x = leaky_relu(linear(params, f'{kind}_dense_{i}', x))
            if i < n_layers - 1:
                x = dropout(generator, x, dense_p, training)
        return x

    def _apply_y_range(self, preds):
        y_range = self.hparams.get('y_range')
        if y_range is not None:
            preds = torch.sigmoid(preds) * (y_range[1] - y_range[0]) + y_range[0]
        return preds

    # the fused [*, D+1] layout of the generic epoch (``BasePipeline``); the
    # bias tables are used in the forward, so the named layout scatters
    # twice a table.  The dense weights pass through unfused
    _FUSED_TABLE_SPEC = (
        ('user_embeddings', 'user_biases', 'user_fused'),
        ('item_embeddings', 'item_biases', 'item_fused'),
    )

    def supports_fused_tables(self) -> bool:
        return self._fused_tables_ok(NonlinearMatrixFactorizationModel)

    def score(self, params, users, items, training=False, generator=None):
        """Draws in the JAX package's order: the user tower's, the item
        tower's, then the embedding dropout of the user and item outputs."""
        user_x, user_b = self._emb_bias_lookup(params, 'user_embeddings', 'user_biases',
                                               'user_fused', users)
        item_x, item_b = self._emb_bias_lookup(params, 'item_embeddings', 'item_biases',
                                               'item_fused', items)
        user_x = self._tower(params, 'user', user_x, training, generator)
        item_x = self._tower(params, 'item', item_x, training, generator)
        emb_p = self.hparams.get('embedding_dropout_p', 0.0)
        user_x = dropout(generator, user_x, emb_p, training)
        item_x = dropout(generator, item_x, emb_p, training)
        return self._apply_y_range((user_x * item_x).sum(dim=1) + user_b + item_b)

    def pairwise_scores(self, params, users, items, training=False, generator=None):
        """The user tower runs once on ``[B, d]`` instead of ``R`` times on
        the tiled rows.  Under dropout it takes the tiled base hook, whose
        independent masks per candidate copy a shared tower cannot give."""
        if training and (self.hparams.get('dense_dropout_p')
                         or self.hparams.get('embedding_dropout_p')):
            return super().pairwise_scores(params, users, items,
                                           training=training, generator=generator)
        user_rows, user_b = self._emb_bias_lookup(params, 'user_embeddings', 'user_biases',
                                                  'user_fused', users)
        item_rows, item_b = self._emb_bias_lookup(params, 'item_embeddings', 'item_biases',
                                                  'item_fused', items)
        user_x = self._tower(params, 'user', user_rows, False, None)
        item_x = self._tower(params, 'item', item_rows, False, None)
        preds = (user_x[None] * item_x).sum(dim=-1) + user_b[None, :] + item_b
        return self._apply_y_range(preds)

    def _post_tower(self, kind: str) -> torch.Tensor:
        """``kind``'s post-tower embeddings of every id, cached under the
        identity and version of the params they read, so a fit, a load or
        an in-place edit recomputes them."""
        names = [f'{kind}_embeddings'] + [
            f'{kind}_dense_{i}_{part}'
            for i in range(len(self.hparams[f'{kind}_dense_layers_dims']))
            for part in ('weight', 'bias')]
        current = [self._parameters[n] for n in names]
        cache = self.__dict__.setdefault('_post_tower_cache', {})
        entry = cache.get(kind)
        if entry is None or any(ref() is not p or version != p._version
                                for (ref, version), p in zip(entry[0], current)):
            params = self.params
            with torch.no_grad():
                x = embedding_lookup(params[f'{kind}_embeddings'],
                                     torch.arange(self.hparams[f'num_{kind}s'],
                                                  device=self.device))
                entry = cache[kind] = ([(weakref.ref(p), p._version) for p in current],
                                       self._tower(params, kind, x, False, None))
        return entry[1]

    def _get_item_embeddings(self) -> torch.Tensor:
        """Post-tower item embeddings (reference ``:214-228``)."""
        return self._post_tower('item')

    def _get_user_embeddings(self) -> torch.Tensor:
        """Post-tower user embeddings (reference ``:230-244``)."""
        return self._post_tower('user')
