"""Optimizers written out by hand, with optax's state and arithmetic.

Port of ``collie_tpu/training/optimizers.py:30-224``.  Each optimizer is an
``OptimizerSpec``: a ``Transform`` plus the flat-param names it owns.  The
transform is the JAX package's optax chain written out:

    inject_hyperparams(learning_rate) o [add_decayed_weights(wd)] o scaler
    o scale_by_learning_rate

with ``scaler`` one of identity ('sgd'), ``scale_by_rss`` ('adagrad', zero
initial accumulator, ``eps=1e-7``) and ``scale_by_adam`` ('adam' and
'sparse_adam', the latter with its weight decay forced to 0).  Adam keeps
optax's layout and numerics: one shared step count, moments
``mu = (1-b1) g + b1 mu`` and ``nu = (1-b2) g^2 + b2 nu``, bias corrections
``1 - b^t`` in float32, ``eps`` outside the square root; torch-coupled weight
decay is added to the gradient before the moments.  ``torch.optim.Adam``
differs in both the state layout and where ``eps`` goes, so it is not used.

The math runs in float32 whatever the parameters' storage dtype (bfloat16
tables keep float32 moments); only the final update is cast to the
parameter's dtype.  The learning rate lives in the state (``OptState.
learning_rate``, a float32 value) so host schedulers change it between
epochs through ``set_lr``; during a whole fit it is a 0-d float32 tensor on
the fit's device, which the device schedulers rewrite without a host sync,
and ``count`` a 0-d int32 tensor there (``whole_fit_states``).  ``OptState.count`` is ``inject_hyperparams``'
own per-update counter, which the fused epoch advances by its step count.

Custom optimizer factories (``collie_tpu/training/optimizers.py:51-63``):
``build_transform(factory, lr, wd)`` calls ``factory(learning_rate=lr,
weight_decay=wd)``, or ``factory(learning_rate=lr)`` when that raises
``TypeError``.  Where the JAX factory returns an optax transform, the port's
returns an object with this module's ``Transform`` contract: ``init(params)
-> state`` and ``update(grads, state, params) -> (updates, state)``.  It is
wrapped so that bfloat16 params and grads reach it as float32 and only its
update is cast back (``_f32_optimizer_math``).  ``get_lr`` / ``set_lr`` need a
state with a ``learning_rate`` field; on any other state they raise the JAX
package's ``ValueError``, so a scheduler that fires on a custom factory's
state fails there, as in JAX.  JAX's ``match_lr_aval`` / ``adopt_lr_aval``
have no counterpart: the learning rate here is a host float32 (or, inside
a whole fit, a device tensor) with no abstract value to keep stable across a
resume.
"""
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
RSS_EPS = 1e-7

_SCALERS = ('sgd', 'adagrad', 'adam', 'sparse_adam')


def _f32_value(x: float) -> float:
    """``x`` rounded to float32, as the JAX state stores a learning rate."""
    return float(np.float32(x))


@dataclasses.dataclass
class OptState:
    """One optimizer's state, mirroring optax's tree for ``build_transform``.

    ``count`` and ``learning_rate`` are ``InjectHyperparamsState.count`` and
    ``hyperparams['learning_rate']``; ``adam_count``/``mu``/``nu`` are
    ``ScaleByAdamState`` (adam only), ``sum_of_squares`` is
    ``ScaleByRssState`` (adagrad only)."""
    count: Union[int, torch.Tensor]                # a 0-d int32 tensor in a whole fit
    learning_rate: Union[float, torch.Tensor]      # a 0-d float32 tensor in a whole fit
    adam_count: Optional[torch.Tensor] = None       # 0-d int32
    mu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    sum_of_squares: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def adam_moments(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """optax ``update_moment`` for both moments."""
    return ((1 - ADAM_B1) * g + ADAM_B1 * mu,
            (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)


def adam_bias_corrections(count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(1 - b1^t, 1 - b2^t)`` in float32 for step counts ``t`` (any shape)."""
    t = count.to(torch.float32)
    # the bases are filled on the device: no host-to-device copy, no sync
    return (1 - torch.pow(torch.full((), ADAM_B1, dtype=torch.float32, device=t.device), t),
            1 - torch.pow(torch.full((), ADAM_B2, dtype=torch.float32, device=t.device), t))


def adam_direction(mu: torch.Tensor, nu: torch.Tensor, bc1: torch.Tensor,
                   bc2: torch.Tensor) -> torch.Tensor:
    """Bias-corrected Adam step direction, ``eps`` outside the square root."""
    return (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)


class Transform:
    """One optimizer over a dict of params: ``init(params) -> OptState``,
    ``update(grads, state, params) -> (updates, state)``; the caller adds
    the updates to the params."""

    def __init__(self, optimizer: str, lr: float, weight_decay: float = 0.0):
        if optimizer not in _SCALERS:
            raise ValueError(f'{optimizer} is not a valid optimizer!')
        if optimizer == 'sparse_adam':
            # torch.optim.SparseAdam has no weight decay
            weight_decay = 0.0
        self.optimizer = optimizer
        self.lr = lr
        self.weight_decay = float(weight_decay or 0.0)

    @property
    def is_adam(self) -> bool:
        return self.optimizer in ('adam', 'sparse_adam')

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        state = OptState(count=0, learning_rate=_f32_value(self.lr))
        if self.is_adam:
            device = next(iter(params.values())).device if params else None
            state.adam_count = torch.zeros((), dtype=torch.int32, device=device)
            state.mu = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                        for k, v in params.items()}
            state.nu = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                        for k, v in params.items()}
        elif self.optimizer == 'adagrad':
            state.sum_of_squares = {
                k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                for k, v in params.items()}
        return state

    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], OptState]:
        g = {k: v.float() for k, v in grads.items()}
        p32 = {k: params[k].float() for k in g}
        if self.weight_decay:
            g = {k: g[k] + self.weight_decay * p32[k] for k in g}
        new = dataclasses.replace(state, count=state.count + 1)
        if self.is_adam:
            moments = {k: adam_moments(g[k], state.mu[k], state.nu[k]) for k in g}
            new.mu = {k: m for k, (m, _) in moments.items()}
            new.nu = {k: n for k, (_, n) in moments.items()}
            new.adam_count = state.adam_count + 1
            bc1, bc2 = adam_bias_corrections(new.adam_count)
            g = {k: adam_direction(new.mu[k], new.nu[k], bc1, bc2) for k in g}
        elif self.optimizer == 'adagrad':
            new.sum_of_squares = {k: g[k] * g[k] + state.sum_of_squares[k] for k in g}
            g = {k: torch.where(s > 0, torch.rsqrt(s + RSS_EPS), 0.0) * g[k]
                 for k, s in new.sum_of_squares.items()}
        updates = {k: (g[k] * (-state.learning_rate)).to(params[k].dtype) for k in g}
        return updates, new


@dataclasses.dataclass
class OptimizerSpec:
    """One optimizer over a static subset of flat-dict params."""
    name: str
    transform: Transform
    keys: List[str]          # flat param names this optimizer owns
    stage: Optional[str] = None  # None -> active in every stage


class _F32OptimizerMath:
    """A custom factory's transform run at float32 whatever the params'
    storage dtype: bfloat16 grads and params are upcast on the way in (so
    its state starts and stays float32), and each update is cast back to
    its param's dtype.  For float32 params every cast is the identity."""

    def __init__(self, inner):
        self.inner = inner

    @staticmethod
    def _f32(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: (v.float() if v.dtype == torch.bfloat16 else v) for k, v in tree.items()}

    def init(self, params: Dict[str, torch.Tensor]) -> Any:
        return self.inner.init(self._f32(params))

    def update(self, grads: Dict[str, torch.Tensor], state: Any,
               params: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Any]:
        out, new_state = self.inner.update(self._f32(grads), state, self._f32(params))
        return {k: u.to(params[k].dtype) for k, u in out.items()}, new_state


def build_transform(optimizer: Union[str, Callable[..., Any]], lr: float,
                    weight_decay: float = 0.0):
    """A transform with torch-coupled weight decay and a state-resident
    learning rate, or a custom factory's transform (module docstring)."""
    if callable(optimizer) and not isinstance(optimizer, str):
        try:
            inner = optimizer(learning_rate=lr, weight_decay=weight_decay)
        except TypeError:
            inner = optimizer(learning_rate=lr)
        return _F32OptimizerMath(inner)
    return Transform(optimizer, lr, weight_decay)


def _check_lr_state(opt_state) -> None:
    if not hasattr(opt_state, 'learning_rate'):
        raise ValueError(
            'Optimizer state carries no injected hyperparams; learning-rate scheduling '
            'requires transforms built by ``build_transform``.'
        )


def get_lr(opt_state) -> float:
    """The learning rate in ``opt_state``, as a host float (a device
    learning rate is read back, which waits for the card)."""
    _check_lr_state(opt_state)
    return float(opt_state.learning_rate)


def host_scalars(opt_state):
    """``opt_state`` with a device learning rate and count (a whole fit's,
    ``whole_fit_states``) brought back to a host float32 value and int, as a
    checkpoint stores them; other states as they are."""
    if torch.is_tensor(getattr(opt_state, 'learning_rate', None)):
        opt_state = set_lr(opt_state, get_lr(opt_state))
    if isinstance(opt_state, OptState) and torch.is_tensor(opt_state.count):
        opt_state = dataclasses.replace(opt_state, count=int(opt_state.count))
    return opt_state


def whole_fit_states(opt_states, scheduled: Sequence[bool], device) -> tuple:
    """The states a whole fit carries: each whose scheduler acts
    (``scheduled``) with its learning rate as a 0-d float32 tensor on
    ``device``, and every ``OptState`` with its ``count`` as a 0-d int32
    tensor there, so a skipped epoch's select keeps both on the card."""
    out = []
    for state, on in zip(opt_states, scheduled):
        if on and not torch.is_tensor(state.learning_rate):
            state = with_lr(state, torch.full((), get_lr(state), dtype=torch.float32,
                                              device=device))
        if isinstance(state, OptState) and not torch.is_tensor(state.count):
            state = dataclasses.replace(state, count=torch.full(
                (), state.count, dtype=torch.int32, device=device))
        out.append(state)
    return tuple(out)


def state_leaves(tree: Any) -> List[Any]:
    """The leaves of an optimizer state in a fixed order: dataclass fields
    in declaration order, dict entries by sorted key, sequence items in
    order; anything else is a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in state_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in state_leaves(item)]
    return [tree]


def state_paths(tree: Any, path: tuple = ()) -> List[Tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf of an optimizer state in
    ``state_leaves``' order; a path holds dataclass field names, dict keys
    and sequence indices."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [item for f in dataclasses.fields(tree)
                for item in state_paths(getattr(tree, f.name), path + (f.name,))]
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in state_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in state_paths(v, path + (i,))]
    return [(path, tree)]


def state_tree(state: Any) -> Any:
    """An optimizer state as plain containers: each dataclass a dict of its
    fields, dicts as dicts, sequences as lists; ``state_from_tree`` puts the
    structure back."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: state_tree(getattr(state, f.name)) for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: state_tree(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [state_tree(v) for v in state]
    return state


def state_from_tree(template: Any, tree: Any) -> Any:
    """``template``'s structure with the leaves of ``state_tree``'s form
    ``tree``."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: state_from_tree(getattr(template, f.name), tree[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: state_from_tree(template[k], tree[k]) for k in template}
    if isinstance(template, (list, tuple)):
        items = [state_from_tree(t, v) for t, v in zip(template, tree)]
        if hasattr(template, '_fields'):
            return type(template)(*items)
        return type(template)(items)
    return tree


def state_from_leaves(template: Any, leaves) -> Any:
    """``template``'s structure with ``state_leaves``' order filled from the
    iterator ``leaves``."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: state_from_leaves(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: state_from_leaves(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        items = [state_from_leaves(item, leaves) for item in template]
        if hasattr(template, '_fields'):
            return type(template)(*items)
        return type(template)(items)
    return next(leaves)


def with_lr(opt_state, lr):
    """``opt_state`` with ``learning_rate`` replaced by ``lr`` as given."""
    _check_lr_state(opt_state)
    if dataclasses.is_dataclass(opt_state):
        return dataclasses.replace(opt_state, learning_rate=lr)
    return opt_state._replace(learning_rate=lr)


def set_lr(opt_state, new_lr: float):
    """``opt_state`` with the learning rate replaced (stored as float32)."""
    return with_lr(opt_state, _f32_value(new_lr))


def split_bias_keys(param_keys: Sequence[str]) -> Tuple[list, list]:
    """The reference's name-based split: params whose name contains 'bias'."""
    bias = [k for k in param_keys if 'bias' in k]
    rest = [k for k in param_keys if 'bias' not in k]
    return bias, rest
