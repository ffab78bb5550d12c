"""Neural collaborative filtering (NCF / NeuMF).

Port of ``collie_tpu/models/neural_collaborative_filtering.py`` (reference
``collie/model/neural_collaborative_filtering.py:13-214``), per
arXiv:1708.05031: a GMF branch (elementwise product of dim-``e``
embeddings) in parallel with an MLP branch (its own ``e * 2^(L-1)``-dim
embedding tables feeding a halving MLP), concatenated into a 1-unit predict
layer with an optional final activation.  Inits mirror the reference:
trunc-normal(0.01) MLP weights, kaiming-uniform(relu) predict layer, zero
layer biases (``:143-153``).  Similarity embeddings are the concatenated
CF + MLP tables (``:198-214``).  Single optimizer (no bias split).  The
tables stay in the named layout (``*_embeddings_cf`` / ``*_embeddings_mlp``).
"""
from typing import Callable, Dict, Optional, Union

import torch

from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, BasePipeline
from collie_tpu_torch.ops.embeddings import dropout, embedding_lookup, scaled_embedding_init
from collie_tpu_torch.ops.nn import add_linear, apply_final_layer, linear
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


class NeuralCollaborativeFiltering(BasePipeline):
    """NeuMF: GMF branch || halving-MLP branch -> predict layer.

    Parameters
    ----------
    embedding_dim: int
        GMF embedding dim; the MLP branch uses ``embedding_dim * 2^(num_layers-1)``
    num_layers: int
        Number of halving MLP layers
    final_layer: str or callable
        Optional output activation: 'sigmoid' / 'relu' / 'leaky_relu' / callable
    dropout_p: float
        Dropout before each MLP layer
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 embedding_dim: int = 8,
                 num_layers: int = 3,
                 final_layer: Optional[Union[str, Callable]] = None,
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
        init_args = get_init_arguments()
        if callable(final_layer):
            init_args['final_layer'] = None  # callables are attributes, not hparams
        super().__init__(**init_args)
        self.final_layer = final_layer

    __doc__ = merge_docstrings(BasePipeline, __doc__, __init__)

    def _build_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        num_users = self.hparams['num_users']
        num_items = self.hparams['num_items']
        dim = self.hparams['embedding_dim']
        num_layers = self.hparams['num_layers']
        mlp_dim = dim * (2 ** (num_layers - 1))
        params = {
            'user_embeddings_cf': scaled_embedding_init(generator, num_users, dim),
            'item_embeddings_cf': scaled_embedding_init(generator, num_items, dim),
            'user_embeddings_mlp': scaled_embedding_init(generator, num_users, mlp_dim),
            'item_embeddings_mlp': scaled_embedding_init(generator, num_items, mlp_dim),
        }
        for i in range(num_layers):
            input_size = dim * (2 ** (num_layers - i))
            add_linear(params, f'mlp_{i}', generator, input_size, input_size // 2,
                       init='trunc_normal')
        add_linear(params, 'predict', generator, dim * 2, 1, init='kaiming_uniform_relu')
        return params

    def _head(self, params, output_cf, x, training, generator):
        """Dropout before each MLP layer (one draw per layer, in layer
        order), then the predict unit over ``concat(cf, mlp)`` and the final
        layer."""
        p = self.hparams.get('dropout_p', 0.0)
        for i in range(self.hparams['num_layers']):
            x = dropout(generator, x, p, training)
            x = torch.relu(linear(params, f'mlp_{i}', x))
        prediction = linear(params, 'predict', torch.cat([output_cf, x], dim=-1))[..., 0]
        return apply_final_layer(prediction, self._resolved_final_layer())

    # the fused layout of the generic epoch: each side's cf and mlp tables
    # share their ids, so they ride as one [*, D + mlp_dim] table, gathered
    # once and scattered into once (JAX ``neural_collaborative_filtering.py:
    # 95-135``).  The halves are both tables, so fuse and unfuse are this
    # model's own
    _FUSED_TABLE_SPEC = (
        ('user_embeddings_cf', 'user_embeddings_mlp', 'user_fused'),
        ('item_embeddings_cf', 'item_embeddings_mlp', 'item_fused'),
    )

    def supports_fused_tables(self) -> bool:
        return self._fused_tables_ok(NeuralCollaborativeFiltering)

    def fuse_params(self, params):
        fused = dict(params)
        for cf_key, mlp_key, fused_key in self._FUSED_TABLE_SPEC:
            if cf_key in fused:
                fused[fused_key] = torch.cat([fused.pop(cf_key), fused.pop(mlp_key)], dim=1)
        return fused

    def unfuse_params(self, fused):
        dim = self.hparams['embedding_dim']
        params = dict(fused)
        for cf_key, mlp_key, fused_key in self._FUSED_TABLE_SPEC:
            if fused_key in params:
                table = params.pop(fused_key)
                params[cf_key], params[mlp_key] = table[:, :dim], table[:, dim:]
        return params

    def _cf_mlp_lookup(self, params, kind: str, ids):
        """``(cf rows, mlp rows)`` for ``ids`` under either layout; a fused
        row is gathered once and sliced after the gather."""
        fused_key = f'{kind}_fused'
        if fused_key in params:
            dim = self.hparams['embedding_dim']
            rows = embedding_lookup(params[fused_key], ids)
            return rows[..., :dim], rows[..., dim:]
        return (embedding_lookup(params[f'{kind}_embeddings_cf'], ids),
                embedding_lookup(params[f'{kind}_embeddings_mlp'], ids))

    def score(self, params, users, items, training=False, generator=None):
        user_cf, user_mlp = self._cf_mlp_lookup(params, 'user', users)
        item_cf, item_mlp = self._cf_mlp_lookup(params, 'item', items)
        x = torch.cat([user_mlp, item_mlp], dim=-1)
        return self._head(params, user_cf * item_cf, x, training, generator)

    def pairwise_scores(self, params, users, items, training=False, generator=None):
        """Both user tables gathered once ``[B, d]`` and broadcast to
        ``[R, B, d]``; the same MLP, draws and final layer as ``score`` per
        candidate pair, so outputs equal the tiled path's element for
        element, dropout included."""
        R, B = items.shape
        user_cf, user_mlp = self._cf_mlp_lookup(params, 'user', users)
        item_cf, item_mlp = self._cf_mlp_lookup(params, 'item', items)
        mlp_dim = user_mlp.shape[-1]
        x = torch.cat([user_mlp[None].expand(R, B, mlp_dim), item_mlp], dim=-1)
        return self._head(params, user_cf[None] * item_cf, x, training, generator)

    def _get_item_embeddings(self) -> torch.Tensor:
        return torch.cat([self.params['item_embeddings_cf'],
                          self.params['item_embeddings_mlp']], dim=1)

    def _get_user_embeddings(self) -> torch.Tensor:
        return torch.cat([self.params['user_embeddings_cf'],
                          self.params['user_embeddings_mlp']], dim=1)
