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
epochs through ``set_lr``.  ``OptState.count`` is ``inject_hyperparams``'
own per-update counter, which the fused epoch advances by its step count.
"""
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
    count: int
    learning_rate: float
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
    return (1 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32, device=t.device), t),
            1 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32, device=t.device), t))


def adam_direction(mu: torch.Tensor, nu: torch.Tensor, bc1: torch.Tensor,
                   bc2: torch.Tensor) -> torch.Tensor:
    """Bias-corrected Adam step direction, ``eps`` outside the square root."""
    return (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)


class Transform:
    """One optimizer over a dict of params: ``init(params) -> OptState``,
    ``update(grads, state, params) -> (updates, state)``; the caller adds
    the updates to the params."""

    def __init__(self, optimizer: str, lr: float, weight_decay: float = 0.0):
        if not isinstance(optimizer, str):
            raise NotImplementedError(
                'custom optimizer factories are not ported yet (ROADMAP Queue 1); '
                "use 'sgd', 'adagrad', 'adam' or 'sparse_adam'")
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


def build_transform(optimizer: str, lr: float, weight_decay: float = 0.0) -> Transform:
    """A transform with torch-coupled weight decay and a state-resident
    learning rate."""
    return Transform(optimizer, lr, weight_decay)


def get_lr(opt_state: OptState) -> float:
    """The learning rate in ``opt_state``."""
    return float(opt_state.learning_rate)


def set_lr(opt_state: OptState, new_lr: float) -> OptState:
    """``opt_state`` with the learning rate replaced (stored as float32)."""
    return dataclasses.replace(opt_state, learning_rate=_f32_value(new_lr))


def split_bias_keys(param_keys: Sequence[str]) -> Tuple[list, list]:
    """The reference's name-based split: params whose name contains 'bias'."""
    bias = [k for k in param_keys if 'bias' in k]
    rest = [k for k in param_keys if 'bias' not in k]
    return bias, rest
