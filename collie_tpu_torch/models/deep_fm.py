"""DeepFM.

Port of ``collie_tpu/models/deep_fm.py`` (reference
``collie/model/deep_fm.py:13-222``), per arXiv:1703.04247 as the reference
implements it: FM term ``sum((u + i) - (u^2 + i^2))`` (``:191-195``) plus an
MLP over the concatenated embeddings, summed, with an optional final
activation.  The reference also allocates per-user/item bias tables and two
global bias scalars that its forward never uses (``:138-139``); they are
kept for state-dict parity and, as there, get the separate bias optimizer
but no gradient signal.
"""
from typing import Callable, Dict, Optional, Union

import torch

from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, BasePipeline
from collie_tpu_torch.ops.embeddings import dropout, embedding_lookup, scaled_embedding_init, \
    zero_embedding_init
from collie_tpu_torch.ops.nn import add_linear, apply_final_layer, linear, shrinking_mlp_dims
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


def _default_scheduler():
    return ReduceLROnPlateau(patience=1)


class DeepFM(BasePipeline):
    """Factorization machine + deep MLP over shared embeddings.

    Parameters
    ----------
    embedding_dim: int
    num_layers: int
        Number of shrinking MLP layers
    final_layer: str or callable
        Optional output activation
    dropout_p: float
    bias_lr: float or 'infer'
    bias_optimizer: str or None
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 embedding_dim: int = 8,
                 num_layers: int = 3,
                 final_layer: Optional[Union[str, Callable]] = None,
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
        device = generator.device
        params = {
            'user_embeddings': scaled_embedding_init(generator, num_users, dim),
            'item_embeddings': scaled_embedding_init(generator, num_items, dim),
            # unused by the forward, kept for parity (reference ``:138-139``)
            'user_biases': zero_embedding_init(num_users, device=device),
            'item_biases': zero_embedding_init(num_items, device=device),
            'user_global_bias': torch.zeros(1, device=device),
            'item_global_bias': torch.zeros(1, device=device),
        }
        input_size = dim * 2
        for i, next_size in enumerate(shrinking_mlp_dims(dim, self.hparams['num_layers'])):
            add_linear(params, f'mlp_{i}', generator, input_size, next_size,
                       init='trunc_normal')
            input_size = next_size
        add_linear(params, 'predict', generator, input_size, 1, init='kaiming_uniform_relu')
        return params

    def _forward(self, params, user_embeddings, item_embeddings, training, generator):
        """FM term (reference ``:191-195``) + the MLP (one dropout draw per
        layer, in layer order) over rows of any leading shape."""
        embedding_sum = user_embeddings + item_embeddings
        embedding_squared_sum = user_embeddings.square() + item_embeddings.square()
        fm_output = (embedding_sum - embedding_squared_sum).sum(dim=-1)
        x = torch.cat([user_embeddings, item_embeddings], dim=-1)
        p = self.hparams.get('dropout_p', 0.0)
        for i in range(self.hparams['num_layers']):
            x = torch.relu(linear(params, f'mlp_{i}', x))
            x = dropout(generator, x, p, training)
        mlp_output = linear(params, 'predict', x)[..., 0]
        return apply_final_layer(fm_output + mlp_output, self._resolved_final_layer())

    def score(self, params, users, items, training=False, generator=None):
        return self._forward(params, embedding_lookup(params['user_embeddings'], users),
                             embedding_lookup(params['item_embeddings'], items),
                             training, generator)

    def pairwise_scores(self, params, users, items, training=False, generator=None):
        """User rows gathered once ``[B, d]`` and broadcast to ``[R, B, d]``;
        the same FM term, MLP, draws and final layer as ``score`` per
        candidate pair, so outputs equal the tiled path's element for
        element, dropout included."""
        R, B = items.shape
        user_embeddings = embedding_lookup(params['user_embeddings'], users)
        user_embeddings = user_embeddings[None].expand(R, B, user_embeddings.shape[-1])
        return self._forward(params, user_embeddings,
                             embedding_lookup(params['item_embeddings'], items),
                             training, generator)

    def _get_item_embeddings(self) -> torch.Tensor:
        return self.params['item_embeddings']

    def _get_user_embeddings(self) -> torch.Tensor:
        return self.params['user_embeddings']
