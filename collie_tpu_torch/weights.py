"""Carry parameters and optimizer state from the JAX package into the port.

``params_from_jax`` turns a JAX model's flat ``{name: array}`` params (as
numpy arrays, e.g. ``{k: np.asarray(v) for k, v in jax_model.params.items()}``)
into tensors under the same names; ``BasePipeline.load_params`` installs
them.  ``optimizer_state_from_jax`` turns one optax state built by the JAX
package's ``build_transform`` (with numpy leaves, e.g. after
``jax.device_get``) into the port's ``OptState``: Adam's ``mu``/``nu``/
``count``, Adagrad's sums of squares, the injected learning rate and
``inject_hyperparams``' own count.  With both, the two packages start a fit
from the same state, which is how the parity tests compare them.  Whole
models travel through the shared npz format instead (``save_model`` /
``load_model_path``).
"""
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from collie_tpu_torch.training.optimizers import OptState


def params_from_jax(params: Dict[str, np.ndarray],
                    device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``,
    copied.  bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16, which torch
    cannot wrap) go through float32, which holds them exactly."""
    out = {}
    for name, value in params.items():
        value = np.asarray(value)
        if value.dtype.name == 'bfloat16':
            tensor = torch.from_numpy(value.astype(np.float32)).to(torch.bfloat16)
        else:
            tensor = torch.from_numpy(np.array(value))
        out[name] = tensor.to(device)
    return out


def _find_node(tree: Any, fields: Sequence[str]) -> Optional[Any]:
    """The first namedtuple in ``tree`` (optax states nest namedtuples,
    tuples and dicts) that has all of ``fields``."""
    if hasattr(tree, '_fields') and all(f in tree._fields for f in fields):
        return tree
    children = ()
    if isinstance(tree, dict):
        children = tree.values()
    elif isinstance(tree, (tuple, list)):
        children = tree
    for child in children:
        found = _find_node(child, fields)
        if found is not None:
            return found
    return None


def optimizer_state_from_jax(opt_state: Any,
                             device: Union[str, torch.device]) -> OptState:
    """One optax state of a ``build_transform`` optimizer -> ``OptState``
    on ``device``."""
    if not hasattr(opt_state, 'hyperparams') or not hasattr(opt_state, 'count'):
        raise ValueError('expected an inject_hyperparams state from build_transform, '
                         f'got {type(opt_state).__name__}')
    state = OptState(count=int(np.asarray(opt_state.count)),
                     learning_rate=float(np.float32(
                         np.asarray(opt_state.hyperparams['learning_rate']))))
    adam = _find_node(opt_state.inner_state, ('count', 'mu', 'nu'))
    if adam is not None:
        state.adam_count = torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                                        device=device)
        state.mu = params_from_jax(dict(adam.mu), device)
        state.nu = params_from_jax(dict(adam.nu), device)
    rss = _find_node(opt_state.inner_state, ('sum_of_squares',))
    if rss is not None:
        state.sum_of_squares = params_from_jax(dict(rss.sum_of_squares), device)
    return state
