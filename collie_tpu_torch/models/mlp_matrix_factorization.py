"""MLP matrix factorization.

Port of ``collie_tpu/models/mlp_matrix_factorization.py`` (reference
``collie/model/mlp_matrix_factorization.py:12-184``):
``score = sigmoid(predict(MLP(concat(user_emb, item_emb)))) + user_bias +
item_bias`` with ReLU + dropout between shrinking layers (widths per
``:114-128``) and an optional ``y_range`` rescale.
"""
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, BasePipeline
from collie_tpu_torch.ops.embeddings import dropout, scaled_embedding_init, \
    zero_embedding_init
from collie_tpu_torch.ops.nn import add_linear, linear, shrinking_mlp_dims
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


class MLPMatrixFactorizationModel(BasePipeline):
    """MF with the dot product replaced by an MLP over concatenated embeddings.

    Parameters
    ----------
    embedding_dim: int
        Number of latent factors for user and item embeddings
    num_layers: int
        Number of shrinking MLP layers
    dropout_p: float
        Probability of dropout on the MLP layers
    bias_lr: float or 'infer'
        Bias terms learning rate
    bias_optimizer: str or None
        Optimizer for all params named ``*bias*`` (incl. MLP layer biases,
        matching the reference's name-based split)
    y_range: tuple
        ``(min, max)`` sigmoid rescale of the output
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 embedding_dim: int = 30,
                 num_layers: int = 3,
                 dropout_p: float = 0.0,
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
        device = generator.device
        params = {
            'user_embeddings': scaled_embedding_init(generator, num_users, dim),
            'item_embeddings': scaled_embedding_init(generator, num_items, dim),
            'user_biases': zero_embedding_init(num_users, device=device),
            'item_biases': zero_embedding_init(num_items, device=device),
        }
        input_size = dim * 2
        for i, next_size in enumerate(shrinking_mlp_dims(dim, self.hparams['num_layers'])):
            add_linear(params, f'mlp_{i}', generator, input_size, next_size,
                       init='torch_default')
            input_size = next_size
        add_linear(params, 'predict', generator, input_size, 1, init='torch_default')
        return params

    def _head(self, params, x, user_b, item_b, training, generator):
        """The tower over ``x [..., 2d]`` (one dropout draw per layer, in
        layer order), the sigmoid predict unit, the biases and ``y_range``."""
        p = self.hparams.get('dropout_p', 0.0)
        for i in range(self.hparams['num_layers']):
            x = torch.relu(linear(params, f'mlp_{i}', x))
            x = dropout(generator, x, p, training)
        preds = torch.sigmoid(linear(params, 'predict', x))[..., 0] + user_b + item_b
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
        return self._fused_tables_ok(MLPMatrixFactorizationModel)

    def score(self, params, users, items, training=False, generator=None):
        user_embeddings, user_b = self._emb_bias_lookup(
            params, 'user_embeddings', 'user_biases', 'user_fused', users)
        item_embeddings, item_b = self._emb_bias_lookup(
            params, 'item_embeddings', 'item_biases', 'item_fused', items)
        x = torch.cat([user_embeddings, item_embeddings], dim=-1)
        return self._head(params, x, user_b, item_b, training, generator)

    def pairwise_scores(self, params, users, items, training=False, generator=None):
        """User rows and biases gathered once ``[B, d]`` and broadcast to
        ``[R, B, d]``; the MLP runs per candidate pair at ``[R, B, .]`` with
        the same per-layer draws, whose masks fill row-major, so outputs
        equal the tiled ``score`` path's element for element, dropout
        included."""
        R, B = items.shape
        user_embeddings, user_b = self._emb_bias_lookup(
            params, 'user_embeddings', 'user_biases', 'user_fused', users)
        item_embeddings, item_b = self._emb_bias_lookup(
            params, 'item_embeddings', 'item_biases', 'item_fused', items)
        dim = user_embeddings.shape[-1]
        x = torch.cat([user_embeddings[None].expand(R, B, dim), item_embeddings], dim=-1)
        return self._head(params, x, user_b[None, :], item_b, training, generator)

    def _get_item_embeddings(self) -> torch.Tensor:
        return self.params['item_embeddings']

    def _get_user_embeddings(self) -> torch.Tensor:
        return self.params['user_embeddings']
