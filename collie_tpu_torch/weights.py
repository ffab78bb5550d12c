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

``read_checkpoint`` reads a training checkpoint (``checkpoint_epoch_<n>.pkl``)
written by either package's ``CollieTrainer``, through an unpickler that
imports nothing: it maps the few globals such a file names, given as
strings, to stand-ins here (optax's state named tuples, numpy's array
reconstruction, ``ml_dtypes.bfloat16``) or to the port's schedulers, and
refuses every other global with ``pickle.UnpicklingError``.  So a
checkpoint of the JAX package loads with neither JAX, optax nor
``collie_tpu`` installed.  ``read_pickle`` is that unpickler for other
files of either package (``parallel.checkpoint``'s ``meta.pkl``).  bfloat16 arrays come back as their bit pattern,
``{BF16_BITS: uint16 array}``, which is also how the port writes them
(``host_leaf``); ``device_leaf`` turns either back into a tensor.
"""
import pickle
from collections import namedtuple
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from collie_tpu_torch.training.optimizers import OptState
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau, StepLR

#: the key of a bfloat16 leaf's bit pattern in a checkpoint
BF16_BITS = '__bfloat16_bits__'


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


# ------------------------------------------------------------ checkpoints

def host_leaf(value: Any) -> Any:
    """A checkpoint leaf on the host: a tensor becomes a numpy array
    (bfloat16 as ``{BF16_BITS: uint16 bits}``, since numpy has no bfloat16
    without ``ml_dtypes``); anything else passes through."""
    if not torch.is_tensor(value):
        return value
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:
        return {BF16_BITS: value.view(torch.int16).numpy().view(np.uint16).copy()}
    return value.numpy().copy()


def device_leaf(value: Any, device: Union[str, torch.device]) -> Any:
    """``host_leaf``'s inverse: a numpy array or a bfloat16 bit pattern
    becomes a tensor on ``device``."""
    if isinstance(value, dict) and set(value) == {BF16_BITS}:
        bits = np.ascontiguousarray(value[BF16_BITS]).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.array(value)).to(device)
    return value


# optax's state named tuples, as far as a build_transform state needs them
EmptyState = namedtuple('EmptyState', [])
ScaleByAdamState = namedtuple('ScaleByAdamState', ['count', 'mu', 'nu'])
ScaleByRssState = namedtuple('ScaleByRssState', ['sum_of_squares'])
InjectHyperparamsState = namedtuple('InjectHyperparamsState',
                                    ['count', 'hyperparams', 'inner_state'])
InjectStatefulHyperparamsState = namedtuple(
    'InjectStatefulHyperparamsState',
    ['count', 'hyperparams', 'hyperparams_states', 'inner_state'])


class _BFloat16:
    """Stands for ``ml_dtypes.bfloat16`` in a pickled dtype."""


class _BFloat16Dtype:
    """A pickled bfloat16 dtype; its pickled state carries nothing needed."""

    def __setstate__(self, state):
        pass


def _dtype(obj, *args):
    return _BFloat16Dtype() if obj is _BFloat16 else np.dtype(obj, *args)


_NUMPY_RECONSTRUCT = np.zeros(1).__reduce__()[0]


class _ArrayState:
    """A pickled numpy array, rebuilt from its state when the unpickler
    sets it; ``_materialize`` then puts ``value`` in its place."""

    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        _, shape, dtype, is_fortran, raw = state
        if isinstance(dtype, _BFloat16Dtype):
            bits = np.frombuffer(raw, dtype='<u2').reshape(shape, order='F' if is_fortran else 'C')
            self.value = {BF16_BITS: np.ascontiguousarray(bits)}
        else:
            self.value = _NUMPY_RECONSTRUCT(np.ndarray, (0,), b'b')
            self.value.__setstate__(state)


_CHECKPOINT_GLOBALS = {
    ('collie_tpu.training.schedulers', 'ReduceLROnPlateau'): ReduceLROnPlateau,
    ('collie_tpu.training.schedulers', 'StepLR'): StepLR,
    ('optax._src.base', 'EmptyState'): EmptyState,
    ('optax._src.transform', 'ScaleByAdamState'): ScaleByAdamState,
    ('optax._src.transform', 'ScaleByRssState'): ScaleByRssState,
    ('optax.schedules._inject', 'InjectHyperparamsState'): InjectHyperparamsState,
    ('optax.schedules._inject', 'InjectStatefulHyperparamsState'):
        InjectStatefulHyperparamsState,
    ('ml_dtypes', 'bfloat16'): _BFloat16,
    ('numpy', 'dtype'): _dtype,
    ('numpy', 'ndarray'): np.ndarray,
    ('numpy.core.multiarray', '_reconstruct'): _ArrayState,
    ('numpy._core.multiarray', '_reconstruct'): _ArrayState,
}


class _CheckpointUnpickler(pickle.Unpickler):
    def __init__(self, file, extra_globals: Optional[Dict] = None):
        super().__init__(file)
        self.globals = {**_CHECKPOINT_GLOBALS, **(extra_globals or {})}

    def find_class(self, module, name):
        try:
            return self.globals[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f'a checkpoint may not name the global {module}.{name}') from None


def read_pickle(file, extra_globals: Optional[Dict] = None) -> Any:
    """A pickle of either package's checkpoints from the open ``file``,
    through the unpickler of ``read_checkpoint`` (the globals it maps, plus
    ``extra_globals``: ``{(module, name): stand-in}``), every array on the
    host."""
    return _materialize(_CheckpointUnpickler(file, extra_globals).load())


def _materialize(tree: Any) -> Any:
    """Replace every ``_ArrayState`` in ``tree`` by its array."""
    if isinstance(tree, _ArrayState):
        return tree.value
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_materialize(v) for v in tree]
    if isinstance(tree, tuple):
        items = [_materialize(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, '_fields') else tuple(items)
    return tree


def read_checkpoint(path) -> Dict[str, Any]:
    """The payload of a ``checkpoint_epoch_<n>.pkl`` written by either
    package: ``params``, ``opt_states``, ``schedulers``, ``epoch``,
    ``global_step`` and ``best_epoch_loss``, every array on the host.  A
    JAX checkpoint's optimizer states come back as the optax stand-ins of
    this module (``optimizer_state_from_jax`` turns each into an
    ``OptState``)."""
    with open(path, 'rb') as f:
        return read_pickle(f)
