"""Dense-layer initializers and appliers for the model zoo's MLP towers.

Port of ``collie_tpu/ops/nn.py``.  The reference's towers are
``torch.nn.Linear`` stacks with various inits: torch's default
kaiming-uniform(a=sqrt(5)) (``mlp_matrix_factorization.py``), xavier-normal
(``nonlinear_matrix_factorization.py:145-159``), NCF's trunc-normal(std=0.01)
MLP + kaiming-uniform(relu) predict layer + zero biases
(``neural_collaborative_filtering.py:143-153``).  Here they are init
functions over the flat param dict, drawing from an explicit
``torch.Generator``.

Layout: weights are ``[in, out]`` under ``{prefix}_weight`` with the bias
under ``{prefix}_bias``, the JAX package's layout and names (not
``nn.Linear``'s ``[out, in]``), so JAX params and npz files carry across
unchanged.  Bias keys contain ``'bias'``, so, as in the reference's
name-based optimizer split, layer biases go to the bias optimizer when one
is configured.
"""
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def _uniform(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2.0 * bound) - bound


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def torch_default_linear_init(generator: torch.Generator, in_dim: int, out_dim: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.nn.Linear default: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(in_dim)
    weight = _uniform(generator, (in_dim, out_dim), bound)
    return weight, _uniform(generator, (out_dim,), bound)


def xavier_normal_linear_init(generator: torch.Generator, in_dim: int, out_dim: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xavier-normal weight + torch-default bias
    (reference ``nonlinear_matrix_factorization.py:145-159``)."""
    std = math.sqrt(2.0 / (in_dim + out_dim))
    weight = std * _normal(generator, (in_dim, out_dim))
    return weight, _uniform(generator, (out_dim,), 1.0 / math.sqrt(in_dim))


def trunc_normal_linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                             std: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCF MLP init: fastai-style approximate truncated normal
    (``normal().fmod_(2) * std``) with zero bias
    (reference ``neural_collaborative_filtering.py:143-153``)."""
    weight = torch.fmod(_normal(generator, (in_dim, out_dim)), 2.0) * std
    return weight, torch.zeros(out_dim, device=generator.device)


def kaiming_uniform_relu_linear_init(generator: torch.Generator, in_dim: int, out_dim: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kaiming-uniform(nonlinearity='relu') weight with zero bias
    (reference predict layers)."""
    weight = _uniform(generator, (in_dim, out_dim), math.sqrt(6.0 / in_dim))
    return weight, torch.zeros(out_dim, device=generator.device)


LINEAR_INITS = {
    'torch_default': torch_default_linear_init,
    'xavier_normal': xavier_normal_linear_init,
    'trunc_normal': trunc_normal_linear_init,
    'kaiming_uniform_relu': kaiming_uniform_relu_linear_init,
}


def add_linear(params: Dict[str, torch.Tensor], prefix: str, generator: torch.Generator,
               in_dim: int, out_dim: int, init: str = 'torch_default') -> None:
    """Insert ``{prefix}_weight [in, out]`` / ``{prefix}_bias [out]`` into the
    flat dict."""
    weight, bias = LINEAR_INITS[init](generator, in_dim, out_dim)
    params[f'{prefix}_weight'] = weight
    params[f'{prefix}_bias'] = bias


def linear(params: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` over the last dim of ``x``."""
    return x @ params[f'{prefix}_weight'] + params[f'{prefix}_bias']


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """Leaky ReLU with slope 0.01, as ``jax.nn.leaky_relu``."""
    return F.leaky_relu(x, negative_slope=0.01)


def apply_final_layer(prediction: torch.Tensor, final_layer) -> torch.Tensor:
    """The zoo's optional output activation: string or callable
    (reference ``neural_collaborative_filtering.py:184-193``)."""
    if final_layer is None:
        return prediction
    if callable(final_layer):
        return final_layer(prediction)
    if final_layer == 'sigmoid':
        return torch.sigmoid(prediction)
    if final_layer == 'relu':
        return torch.relu(prediction)
    if final_layer == 'leaky_relu':
        return leaky_relu(prediction)
    raise ValueError(f'{final_layer} not valid final layer value!')


def shrinking_mlp_dims(embedding_dim: int, num_layers: int) -> List[int]:
    """The reference's shrinking layer-width formula
    (``mlp_matrix_factorization.py:114-128``): layer i maps to
    ``int(embedding_dim * 2 * (num_layers - i) / (num_layers + 1))``."""
    return [int(embedding_dim * 2 * (num_layers - i) / (num_layers + 1))
            for i in range(num_layers)]
