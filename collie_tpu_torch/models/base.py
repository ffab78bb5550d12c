"""``BasePipeline``: the model core.

Port of ``collie_tpu/models/base.py``.  The model is an ``nn.Module`` whose
parameters are registered under the JAX package's flat names
(``user_embeddings``, ``item_biases``, ...), so ``state_dict()`` keys equal
the JAX param names.  Compute keeps the JAX functional form:
``score(params, users, items)`` takes a dict of tensors (``model.params``),
so parity tests compare like with like.

Ported here: construction and hyperparameter capture, loss resolution (the
``_is_implicit`` hparam; ``loss_function`` is the resolved loss's name in
``ops/losses.LOSSES``), the training half (``calculate_loss`` with the
JAX package's sparse-hardest, sparse-WARP and dense forms and dropout
streams, the fused ``[*, D+1]`` table layout's hooks, and
``optimizer_specs``' dual adam-embeddings / sgd-biases layout),
``embeddings_dtype`` storage, full-catalog and tile scoring (the default
hooks bounded for MLP towers), the prediction and
similarity APIs, and ``save_model`` / ``load_model_path`` in the JAX
package's npz format (``param:<name>`` arrays plus ``hparams_json``), so a
model saved by either package loads in the other.  The constructor's
keyword arguments reach ``_setup_model`` and ``_load_model_init_helper``
(metadata arrays, a donor model), and ``_extra_save_arrays`` /
``_restore_extra_arrays`` let a subclass add arrays to the npz, as in the
JAX package.  Dropout draws from an
explicit ``torch.Generator`` (``ops/embeddings.py``); ``score(...,
training=True, generator=g)`` applies it.

Device: models live on ``cuda`` unless ``map_location`` asks for another
device (``'cpu'`` in the tests); with no GPU and no explicit device,
construction raises.

Shards: after a mesh fit (``CollieTrainer(mesh=)``) or a resume from a
``.shards`` checkpoint under a mesh, ``params`` holds this rank's row
shard of every table the mesh split and the other leaves whole, and
``param_layout()`` gives ``(mesh, {name: spec})`` beside them, as a JAX
model's params are global arrays whose devices hold only their shards.  The
mesh tiers of ``recommend`` and ``evaluate_in_batches`` serve such a model
as it is.  What needs whole tables (``save_model``, ``forward``, the
prediction and similarity APIs, the single-device ``recommend`` and
``evaluate_in_batches``) gathers them first (``gathered``): that costs
``O(table)`` on every rank, as JAX's ``np.asarray`` of a global array does,
and, being a collective, every rank must make the same call.
"""
import contextlib
import functools
import json
import os
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import pandas as pd
import torch
from torch import nn

from collie_tpu_torch.data import (BaseInteractions, ExplicitInteractions, Interactions,
                                   InteractionsDataLoader)
from collie_tpu_torch.ops import losses as loss_lib
from collie_tpu_torch.ops.embeddings import embedding_lookup, split_generator
from collie_tpu_torch.training.optimizers import (OptimizerSpec, build_transform,
                                                  split_bias_keys)
from collie_tpu_torch.training.profiler import annotate
from collie_tpu_torch.utils import get_random_seed

INTERACTIONS_LIKE_INPUT = Union[BaseInteractions, InteractionsDataLoader, None]


def _whole_tables(method):
    """Run ``method`` with the whole tables installed (``gathered``)."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self.gathered():
            return method(self, *args, **kwargs)
    return wrapper


def resolve_device(map_location: Optional[Union[str, torch.device]]) -> torch.device:
    """``map_location`` as a device: ``None`` means the CUDA device, and a
    CUDA device must exist."""
    device = torch.device('cuda' if map_location is None else map_location)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'collie_tpu_torch runs on a CUDA device and none is available; pass '
            "``map_location='cpu'`` to run on the CPU.")
    return device


class HParams(dict):
    """Hyperparameter dict with attribute access
    (``model.hparams.num_epochs_completed`` alongside ``model.hparams['...']``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as err:
            raise AttributeError(name) from err

    def __setattr__(self, name, value):
        self[name] = value


class BasePipeline(nn.Module):
    """Abstract recommender pipeline.  Subclasses MUST implement
    ``_build_params`` and ``score``; ``_get_item_embeddings`` /
    ``_get_user_embeddings`` enable the similarity APIs."""

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 lr: float = 1e-3,
                 lr_scheduler_func: Optional[Any] = None,
                 weight_decay: float = 0.0,
                 optimizer: Union[str, Callable] = 'adam',
                 loss: Union[str, Callable] = 'hinge',
                 metadata_for_loss: Optional[Dict[str, np.ndarray]] = None,
                 metadata_for_loss_weights: Optional[Dict[str, float]] = None,
                 load_model_path: Optional[Union[str, Path]] = None,
                 map_location: Optional[Union[str, torch.device]] = None,
                 **kwargs):
        """Common pipeline construction (reference ``base_pipeline.py:131-243``).

        Parameters
        ----------
        train: Interactions or InteractionsDataLoader
            Training data. A raw ``Interactions`` is auto-wrapped in an
            ``InteractionsDataLoader`` with ``shuffle=True``
        val: Interactions or InteractionsDataLoader
            Validation data, auto-wrapped with ``shuffle=False``
        lr: float
            Model learning rate
        lr_scheduler_func: callable or scheduler instance
            Learning rate scheduler used during fitting (e.g.
            ``collie_tpu_torch.training.ReduceLROnPlateau``)
        weight_decay: float
            Coupled (torch-style) weight decay added to gradients
        optimizer: str or callable
            One of 'sgd' / 'adagrad' / 'adam' / 'sparse_adam'
        loss: str or callable
            'bpr' / 'adaptive_bpr' / 'hinge' / 'adaptive_hinge' / 'adaptive' /
            'warp' (implicit) or 'mse' / 'mae' (explicit); adaptive variants
            auto-selected when ``num_negative_samples > 1``
        metadata_for_loss: dict
            Categorical item metadata arrays (``num_items``-long) for
            partial-credit losses
        metadata_for_loss_weights: dict
            Weight per metadata key; weights must sum to <= 1
        load_model_path: str or Path
            Load a previously saved model instead of building a new one
        map_location: str or torch.device
            Device of the parameters; ``None`` means ``'cuda'``, and
            construction raises when no CUDA device exists
        """
        super().__init__()
        self._device = resolve_device(map_location)

        if isinstance(train, (Interactions, ExplicitInteractions)):
            train = InteractionsDataLoader(interactions=train, shuffle=True)
        if isinstance(val, (Interactions, ExplicitInteractions)):
            val = InteractionsDataLoader(interactions=val, shuffle=False)

        # datasets are deliberately NOT part of hparams (never saved)
        self.train_loader = train
        self.val_loader = val

        # function-valued settings live as attributes, not hparams
        self.lr_scheduler_func = lr_scheduler_func
        self.loss = loss
        self.optimizer = optimizer
        self.bias_optimizer = kwargs.get('bias_optimizer')
        self.metadata_for_loss = _as_array_dict(metadata_for_loss)
        self.metadata_for_loss_weights = metadata_for_loss_weights

        self.hparams: Dict[str, Any] = HParams()

        if load_model_path is not None:
            self._load_model_init_helper(load_model_path=load_model_path, **kwargs)
            return

        if self.train_loader is None:
            raise TypeError('``train`` must be provided to all newly-instantiated models!')
        if self.val_loader is not None:
            assert self.train_loader.num_users == self.val_loader.num_users, (
                'Both training and val ``num_users`` must equal: '
                f'{self.train_loader.num_users} != {self.val_loader.num_users}.'
            )
            assert self.train_loader.num_items == self.val_loader.num_items, (
                'Both training and val ``num_items`` must equal: '
                f'{self.train_loader.num_items} != {self.val_loader.num_items}.'
            )
            train_negs = getattr(self.train_loader, 'num_negative_samples', None)
            val_negs = getattr(self.val_loader, 'num_negative_samples', None)
            if train_negs is not None and val_negs is not None:
                err = (
                    'Training and val ``num_negative_samples`` must both equal ``1`` or both '
                    f'be greater than ``1``, not: {train_negs} and {val_negs}.'
                )
                if train_negs == 1:
                    assert val_negs == 1, err
                elif train_negs > 1:
                    assert val_negs > 1, err
                else:
                    raise ValueError(
                        f'``num_negative_samples`` must be greater than 0, not {train_negs}.'
                    )

        # freeze hyperparameters; function-valued / data-valued entries stay
        # attributes only
        self.hparams.update({
            'lr': lr,
            'weight_decay': weight_decay,
            'optimizer': optimizer if isinstance(optimizer, str) else None,
            'loss': loss if isinstance(loss, str) else None,
            'metadata_for_loss_weights': metadata_for_loss_weights,
        })
        for key, value in kwargs.items():
            if key in ('item_metadata', 'user_metadata', 'trained_model'):
                continue
            self.hparams[key] = value
        self.hparams['num_users'] = self.train_loader.num_users
        self.hparams['num_items'] = self.train_loader.num_items
        self.hparams['num_epochs_completed'] = 0
        self.hparams.setdefault('seed', kwargs.get('seed') or get_random_seed())

        for meta_key in ('item_metadata', 'user_metadata'):
            meta_val = kwargs.get(meta_key)
            if meta_val is not None and np.isnan(np.asarray(meta_val, dtype=np.float64)).any():
                raise ValueError(f'``{meta_key}`` may not contain nulls')

        self._configure_loss()

        if self.hparams.get('sparse') and self.hparams.get('weight_decay', 0.0) != 0:
            warnings.warn(
                '``weight_decay`` must be 0 when ``sparse`` is flagged. Setting to 0. '
                '(``sparse`` embeddings map to dense tables here; the flag is '
                'honored for optimizer-compatibility parity only.)'
            )
            self.hparams['weight_decay'] = 0.0

        self._setup_model(**kwargs)

    # ------------------------------------------------------------------ setup

    #: storage dtypes accepted for ``embeddings_dtype``; compute is float32
    #: (lookups upcast right after the row gather)
    _EMBEDDINGS_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}

    def _setup_model(self, **kwargs) -> None:
        """Build the parameters from a ``torch.Generator`` on the model's
        device, seeded from ``hparams['seed']``.  ``kwargs`` are the
        constructor's (metadata arrays, a donor model), for subclasses that
        need them."""
        generator = torch.Generator(device=self._device)
        generator.manual_seed(int(self.hparams['seed']))
        self.load_params(self._build_params(generator))

    def _apply_embeddings_dtype(self, params: Dict[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
        """Cast embedding *tables* (keys containing ``'embedding'``) to the
        storage dtype from ``hparams['embeddings_dtype']``; biases stay
        float32."""
        name = self.hparams.get('embeddings_dtype') or 'float32'
        if name not in self._EMBEDDINGS_DTYPES:
            raise ValueError(
                f"``embeddings_dtype`` must be one of "
                f"{sorted(self._EMBEDDINGS_DTYPES)}, not {name!r}.")
        dtype = self._EMBEDDINGS_DTYPES[name]
        return {k: (v.to(dtype) if 'embedding' in k else v)
                for k, v in params.items()}

    def _build_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError('``_build_params`` must be implemented in all subclasses.')

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """``{name: tensor}`` view of the parameters (detached), the dict that
        ``score`` and the scoring hooks take."""
        return {name: p.detach() for name, p in self._parameters.items()}

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Install ``{name: tensor}`` as the model's parameters, on the
        model's device and in its ``embeddings_dtype`` (for instance the
        output of ``collie_tpu_torch.weights.params_from_jax``)."""
        self._install(params)
        self._param_layout = None

    def load_shards(self, shards: Dict[str, torch.Tensor], mesh, specs: Dict[str, tuple]) -> None:
        """Install this rank's ``shards`` of the params under ``mesh``, each
        split by its spec in ``specs`` (``()``: the whole leaf)."""
        self._install(shards)
        self._param_layout = (mesh, {name: tuple(specs.get(name, ())) for name in shards})

    def _install(self, params: Dict[str, torch.Tensor]) -> None:
        params = self._apply_embeddings_dtype(
            {k: v.to(self.device) for k, v in params.items()})
        for name in list(self._parameters):
            if name not in params:
                del self._parameters[name]
        for name, value in params.items():
            self.register_parameter(
                name, nn.Parameter(value, requires_grad=value.is_floating_point()))

    def param_layout(self):
        """``(mesh, {name: spec})`` when ``params`` holds this rank's shards
        (module docstring), else None."""
        return getattr(self, '_param_layout', None)

    def global_shapes(self) -> Dict[str, tuple]:
        """Each param's whole shape, whether the model holds it or a shard."""
        from collie_tpu_torch.parallel.sharding import global_shape

        layout = self.param_layout()
        return {name: (tuple(value.shape) if layout is None
                       else global_shape(value.shape, layout[0], layout[1][name]))
                for name, value in self.params.items()}

    def whole_params(self) -> Dict[str, torch.Tensor]:
        """The whole params on the model's device: gathered over the mesh
        when the model holds shards (``O(table)`` a rank, a collective every
        rank must call), else ``params``."""
        layout = self.param_layout()
        if layout is None:
            return self.params
        from collie_tpu_torch.parallel.distributed import gather_global

        mesh, specs = layout
        return {name: gather_global(value, mesh, specs[name]).to(self.device)
                for name, value in self.params.items()}

    @contextlib.contextmanager
    def gathered(self):
        """Within the block the model holds its whole params
        (``whole_params``); its shards come back after it."""
        layout = self.param_layout()
        if layout is None:
            yield
            return
        shards = self.params
        self.load_params(self.whole_params())
        try:
            yield
        finally:
            self.load_shards(shards, *layout)

    @property
    def device(self) -> torch.device:
        """Device of the parameters."""
        for value in self._parameters.values():
            return value.device
        return self._device

    # ------------------------------------------------------------- loss setup

    def _configure_loss(self) -> None:
        """String loss resolution with the automatic adaptive upgrade /
        downgrade (reference ``base_pipeline.py:277-340``).  Sets
        ``self.loss_function`` to the resolved loss name (or the callable)."""
        self.loss_function = None

        if callable(self.loss):
            self.loss_function = self.loss
            self.hparams['_is_implicit'] = not isinstance(
                self.train_loader.interactions, ExplicitInteractions)
            return

        self.hparams['_is_implicit'] = False
        if self.loss in ('mse', 'mae'):
            self.loss_function = self.loss
            return

        self.hparams['_is_implicit'] = True
        num_negative_samples = getattr(self.train_loader, 'num_negative_samples', None)
        if num_negative_samples is None:
            raise ValueError(
                '``num_negative_samples`` attribute not found in ``train_loader`` - are you '
                'using explicit data with an implicit loss function?'
            )
        if self.loss == 'warp':
            if num_negative_samples > 1:
                self.loss_function = 'warp'
                return
            raise ValueError('Cannot use WARP loss with a single negative sample!')
        if 'bpr' in self.loss:
            if num_negative_samples > 1:
                self.loss_function = 'adaptive_bpr'
            else:
                if 'adaptive' in self.loss:
                    warnings.warn(
                        'Adaptive BPR loss specified, but ``num_negative_samples`` == 1. '
                        'Using standard BPR loss instead.'
                    )
                self.loss_function = 'bpr'
            return
        if 'hinge' in self.loss or self.loss == 'adaptive':
            if num_negative_samples > 1:
                self.loss_function = 'adaptive_hinge'
            else:
                if 'adaptive' in self.loss:
                    warnings.warn(
                        'Adaptive hinge loss specified, but ``num_negative_samples`` == 1. '
                        'Using standard hinge loss instead.'
                    )
                self.loss_function = 'hinge'
            return
        raise ValueError(f'{self.loss} is not a valid loss function.')

    # ---------------------------------------------------------- loss compute

    def _loss_fn(self) -> Callable:
        """The resolved loss as a function."""
        if callable(self.loss_function):
            return self.loss_function
        return loss_lib.LOSSES[self.loss_function]

    def loss_metadata(self) -> Optional[Dict[str, torch.Tensor]]:
        """``metadata_for_loss`` as tensors on the model's device, converted
        once and reused while the arrays stay the same objects."""
        if not self.metadata_for_loss:
            return None
        cached = getattr(self, '_loss_metadata_cache', None)
        source = tuple((k, id(v)) for k, v in self.metadata_for_loss.items())
        if cached is None or cached[0] != source or cached[2] != self.device:
            tensors = {k: torch.as_tensor(np.asarray(v), device=self.device)
                       for k, v in self.metadata_for_loss.items()}
            self._loss_metadata_cache = cached = (source, tensors, self.device)
        return cached[1]

    def calculate_loss(self,
                       params: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       training: bool = True) -> torch.Tensor:
        """Batch-shape-dispatched loss (reference ``base_pipeline.py:582-654``).

        Implicit batches carry ``neg_items [B, K]``, explicit ones
        ``ratings``.  The implicit branch takes one of the JAX package's
        three forms (``collie_tpu/models/base.py:429-540``), in its order and
        under its preconditions: with ``K > 1``, ``training`` and a
        deterministic ``score`` (no active dropout),

        * the sparse-hardest backward for the adaptive hinge and BPR losses:
          the K negatives are scored without gradient
          (``pairwise_scores_select``), the argmax (first maximum on ties)
          picks each row's hardest negative, and the positive and that
          negative are scored with gradient in one ``pairwise_scores`` call,
          under the non-adaptive loss (``_adaptive_base_loss``);
        * the WARP first violation: the positive and the negatives scored
          without gradient in one selection call, then ``warp_loss_sparse``;

        and otherwise the dense form, every negative scored with the params
        it is differentiated against.  ``COLLIE_TPU_SPARSE_ADAPTIVE=0``
        keeps the dense form.  A sparse form's selection pass (with the
        argmax of the adaptive losses) is a ``collie.loss.select`` span.
        ``generator`` feeds dropout; it splits into one stream for the
        positives and one for the negatives, as JAX's
        ``_split_or_none`` (``collie_tpu/models/base.py:893``).
        """
        mask = batch.get('mask')
        if 'neg_items' in batch:
            if self.hparams.get('_is_implicit') is False:
                raise ValueError('Explicit loss with implicit data is invalid!')
            users = batch['users'].long()
            pos_items = batch['pos_items'].long()
            neg_items = batch['neg_items'].long().T  # [K, B], the reference's convention
            gen_pos, gen_neg = split_generator(generator)
            K, B = neg_items.shape
            loss_fn = self._loss_fn()
            sparse = training and self.selection_route(K) == 'sparse'
            base_loss = self._adaptive_base_loss() if sparse else None
            if base_loss is not None:
                with annotate('collie.loss.select'):
                    neg_preds_ng = self.pairwise_scores_select(params, users, neg_items,
                                                               training=training,
                                                               generator=gen_neg)
                    hardest_items = neg_items[torch.argmax(neg_preds_ng, dim=0),
                                              torch.arange(B, device=neg_items.device)]
                # positive and hardest negative in ONE call: each table is
                # gathered, and scattered into, once
                pos_preds, neg_preds = self.pairwise_scores(
                    params, users, torch.stack([pos_items, hardest_items]),
                    training=training, generator=gen_pos)
                neg_items, loss_fn = hardest_items, loss_lib.LOSSES[base_loss]
            elif sparse:  # WARP
                with annotate('collie.loss.select'):
                    all_ng = self.pairwise_scores_select(
                        params, users, torch.cat([pos_items[None], neg_items]),
                        training=training, generator=gen_neg)
                return loss_lib.warp_loss_sparse(
                    all_ng[0], all_ng[1:],
                    rescore_pair=lambda items: self.pairwise_scores(
                        params, users, torch.stack([pos_items, items]),
                        training=training, generator=gen_neg),
                    num_items=self.hparams['num_items'],
                    positive_items=pos_items,
                    negative_items=neg_items,
                    metadata=self.loss_metadata(),
                    metadata_weights=self.metadata_for_loss_weights,
                    sample_weights=mask,
                )
            else:
                pos_preds = self.score(params, users, pos_items,
                                       training=training, generator=gen_pos)
                neg_preds = self.pairwise_scores(params, users, neg_items,
                                                 training=training, generator=gen_neg)
                if K == 1:
                    neg_preds = neg_preds[0]
                    neg_items = neg_items[0]
            return _call_loss(
                loss_fn, pos_preds, neg_preds,
                num_items=self.hparams['num_items'],
                positive_items=pos_items,
                negative_items=neg_items,
                metadata=self.loss_metadata(),
                metadata_weights=self.metadata_for_loss_weights,
                sample_weights=mask,
            )
        if 'ratings' in batch:
            if self.hparams.get('_is_implicit') is True:
                raise ValueError('Implicit loss with explicit data is invalid!')
            preds = self.score(params, batch['users'].long(), batch['items'].long(),
                               training=training, generator=generator)
            return _call_loss(self._loss_fn(), preds, batch['ratings'].float(),
                              sample_weights=mask)
        raise ValueError(f'Unexpected format for batch with keys: {sorted(batch)}.')

    @staticmethod
    def _sparse_selection_enabled() -> bool:
        """``COLLIE_TPU_SPARSE_ADAPTIVE=0`` keeps ``calculate_loss`` on the
        dense form (default ``'1'``)."""
        return os.environ.get('COLLIE_TPU_SPARSE_ADAPTIVE', '1') != '0'

    @staticmethod
    def _bf16_select_enabled() -> bool:
        """``COLLIE_TPU_BF16_SELECT=0`` makes every selection pass float32
        (default ``'auto'``: the models that have a bfloat16 pass use it)."""
        return os.environ.get('COLLIE_TPU_BF16_SELECT', 'auto') != '0'

    def _adaptive_base_loss(self) -> Optional[str]:
        """The loss an adaptive loss applies to the hardest negative after
        the selection (``'hinge'`` or ``'bpr'``), or None where the
        sparse-hardest backward does not apply (another loss, or the knob
        off)."""
        if not self._sparse_selection_enabled():
            return None
        return {'adaptive_hinge': 'hinge', 'adaptive_bpr': 'bpr'}.get(self._loss_name())

    def _loss_name(self) -> Optional[str]:
        """The resolved loss's name in ``ops/losses.LOSSES`` (a loss passed
        as one of those functions included), else None."""
        if isinstance(self.loss_function, str):
            return self.loss_function
        return next((name for name, fn in loss_lib.LOSSES.items()
                     if fn is self.loss_function), None)

    def selection_route(self, num_negatives: int) -> str:
        """The implicit ``calculate_loss`` form a training step takes at
        ``num_negatives`` per example: ``'sparse'`` or ``'dense'``."""
        sparse = (num_negatives > 1 and self._score_is_deterministic()
                  and (self._adaptive_base_loss() is not None
                       or (self._sparse_selection_enabled() and self._loss_name() == 'warp')))
        return 'sparse' if sparse else 'dense'

    def selection_precision(self) -> str:
        """The precision of the selection pass: ``'bf16'`` or ``'f32'``."""
        return 'f32'

    def pairwise_scores(self,
                        params: Dict[str, torch.Tensor],
                        users: torch.Tensor,
                        items: torch.Tensor,
                        training: bool = False,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Scores ``[R, B]`` of users ``[B]`` against item ids ``[R, B]``.
        Default: the pairwise ``score`` over the tiled users, the
        reference's multi-negative forward (``base_pipeline.py:602-607``)."""
        R, B = items.shape
        flat = self.score(params, users.repeat(R), items.reshape(-1),
                          training=training, generator=generator)
        return flat.reshape(R, B)

    def pairwise_scores_select(self,
                               params: Dict[str, torch.Tensor],
                               users: torch.Tensor,
                               items: torch.Tensor,
                               training: bool = False,
                               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Gradient-free scores ``[R, B]`` used only to SELECT the hardest
        (adaptive losses) or first-violating (WARP) negative in
        ``calculate_loss``'s sparse forms; the selected pair is scored again
        with gradient by ``pairwise_scores``.  Default: ``pairwise_scores``
        detached.  MF overrides it with a bfloat16 pass."""
        with torch.no_grad():
            return self.pairwise_scores(params, users, items, training=training,
                                        generator=generator)

    _DROPOUT_HPARAMS = ('dropout_p', 'dense_dropout_p', 'embedding_dropout_p')

    def _score_is_deterministic(self) -> bool:
        """True when ``score()`` has no active dropout."""
        return all(not self.hparams.get(name) for name in self._DROPOUT_HPARAMS)

    # ----------------------------------------- the fused [*, D+1] table layout
    #
    # The JAX engine's generic epoch carries each (embeddings, biases) pair
    # of a model that declares ``_FUSED_TABLE_SPEC`` as one ``[*, D+1]``
    # table, the bias its last column (``collie_tpu/models/base.py:
    # 302-368``): the score hooks gather a fused row once and slice it, so
    # the backward scatters once per table instead of twice.  The optimizer
    # still updates the named slices; the values are the named layout's.

    #: ``((emb_key, bias_key, fused_key), ...)``; empty: no fused layout
    _FUSED_TABLE_SPEC: tuple = ()

    def supports_fused_tables(self) -> bool:
        """Whether the generic epoch may carry this model's tables fused
        (``COLLIE_TPU_FUSED_TABLES``): each supporting model overrides it
        with an exact-type check, since a subclass may hold params outside
        the fused contract; False here."""
        return False

    def _fused_tables_ok(self, exact_type) -> bool:
        """The shared gate: the exact type, a declared spec, and float32
        tables (bfloat16 tables cannot take a float32 bias column without
        changing how the bias is stored)."""
        return (type(self) is exact_type
                and bool(self._FUSED_TABLE_SPEC)
                and (self.hparams.get('embeddings_dtype') or 'float32') == 'float32')

    def fuse_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Named layout -> fused layout; other keys, and a pair that is not
        in ``params``, pass through."""
        fused = dict(params)
        for emb_key, bias_key, fused_key in self._FUSED_TABLE_SPEC:
            if emb_key in fused:
                fused[fused_key] = torch.cat([fused.pop(emb_key),
                                              fused.pop(bias_key)[:, None]], dim=1)
        return fused

    def unfuse_params(self, fused: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Fused layout -> named layout (views of the fused tables); other
        keys, and a fused key that is not in ``fused``, pass through."""
        params = dict(fused)
        for emb_key, bias_key, fused_key in self._FUSED_TABLE_SPEC:
            if fused_key in params:
                table = params.pop(fused_key)
                params[emb_key], params[bias_key] = table[:, :-1], table[:, -1]
        return params

    @staticmethod
    def _emb_bias_lookup(params, emb_key: str, bias_key: str, fused_key: str,
                         ids: torch.Tensor):
        """``(embedding rows, bias values)`` for ``ids`` of any shape under
        either layout: rows come back as ``ids.shape + (d,)``, biases as
        ``ids.shape``.  A fused row is gathered once and sliced after the
        gather, so the backward scatters into the table once."""
        if fused_key in params:
            rows = embedding_lookup(params[fused_key], ids)
            return rows[..., :-1], rows[..., -1]
        return embedding_lookup(params[emb_key], ids), params[bias_key][ids]

    # ----------------------------------------------------------- optimizers

    def optimizer_specs(self) -> List[OptimizerSpec]:
        """Optimizer layout consumed by the trainer: single optimizer, or the
        reference's dual bias/non-bias scheme when ``bias_optimizer`` is set
        (``base_pipeline.py:342-479``)."""
        keys = sorted(self.params.keys())
        lr = self.hparams['lr']
        weight_decay = self.hparams.get('weight_decay', 0.0)

        if self.bias_optimizer is not None:
            bias_optimizer = self.bias_optimizer
            if bias_optimizer == 'infer':
                bias_optimizer = self.optimizer
            bias_lr = self.hparams.get('bias_lr', 'infer')
            if bias_lr == 'infer':
                bias_lr = lr
            bias_keys, rest_keys = split_bias_keys(keys)
            specs = []
            if rest_keys:
                specs.append(OptimizerSpec(
                    name='all_but_bias',
                    transform=build_transform(self.optimizer, lr, weight_decay),
                    keys=rest_keys))
            if bias_keys:
                specs.append(OptimizerSpec(
                    name='bias',
                    transform=build_transform(bias_optimizer, bias_lr, weight_decay),
                    keys=bias_keys))
            return specs

        return [OptimizerSpec(name='all',
                              transform=build_transform(self.optimizer, lr, weight_decay),
                              keys=keys)]

    @property
    def current_stage(self) -> Optional[str]:
        """Single-stage models have no stage."""
        return None

    def _sharded_eval_localizable(self) -> bool:
        """True when scoring reads params ONLY through user-id gathers on
        ``[num_users, ...]`` leaves and item-id gathers on ``[num_items, ...]``
        leaves (no id-indexed constants): the sharded evaluator may then
        score through a localized view of each rank's row shards
        (``evaluate._sharded_evaluate``).  Models that gather non-param
        arrays by id (hybrids' metadata, cold start's bucket map) override
        this."""
        return True

    # ------------------------------------------------------------- inference

    def score(self,
              params: Dict[str, torch.Tensor],
              users: torch.Tensor,
              items: torch.Tensor,
              training: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward pass: ``(params, user IDs, item IDs) -> scores``;
        ``training`` with a ``generator`` applies the model's dropout."""
        raise NotImplementedError('``score`` must be implemented in all subclasses.')

    def _resolved_final_layer(self):
        """NeuMF's and DeepFM's output activation: a callable ``final_layer``
        (an attribute, never an hparam) or the hparam's string."""
        final_layer = getattr(self, 'final_layer', None)
        return final_layer if callable(final_layer) else self.hparams.get('final_layer')

    def _ids(self, ids) -> torch.Tensor:
        """Host ids (list, numpy, tensor) as an int64 tensor on the model's device."""
        if isinstance(ids, torch.Tensor):
            return ids.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)

    @_whole_tables
    def forward(self,
                users: Union[np.ndarray, Iterable[int]],
                items: Union[np.ndarray, Iterable[int]]) -> np.ndarray:
        """Eval-mode scoring of (user, item) ID pairs -> numpy scores."""
        with torch.no_grad():
            return self.score(self.params, self._ids(users), self._ids(items)).cpu().numpy()

    #: (user, item) pairs the default ``score_item_block`` scores in one
    #: ``score`` call: an MLP tower's activations over 2**19 pairs stay
    #: within a few hundred MB (the NeuMF concat of two 64-wide rows: 268 MB)
    SCORE_BLOCK_PAIRS = 1 << 19

    def score_all_items(self,
                        params: Dict[str, torch.Tensor],
                        user_ids: torch.Tensor) -> torch.Tensor:
        """Full-catalog scores ``[len(user_ids), num_items]``, the primitive
        behind evaluation.  Default: ``score_item_block`` over the whole
        catalog; factorization models override it with one matmul."""
        num_items = self.hparams['num_items']
        items = torch.arange(num_items, device=user_ids.device)
        return self.score_item_block(params, user_ids, items)

    def score_item_block(self,
                         params: Dict[str, torch.Tensor],
                         user_ids: torch.Tensor,
                         item_ids: torch.Tensor) -> torch.Tensor:
        """Scores for every (user, item) pair of a user batch x item tile:
        ``[len(user_ids), len(item_ids)]``, the tile primitive behind
        blockwise retrieval.  Default: the pairwise ``score``, over item
        chunks of at most ``SCORE_BLOCK_PAIRS`` pairs so that a tower's
        activations stay bounded.  Each pair is scored alone and every chunk
        of a call at one shape (the last one padded), so an item's score
        does not depend on which chunk holds it.  Factorization models
        override it with one matmul over the tile."""
        B, T = user_ids.shape[0], item_ids.shape[0]
        chunk = min(T, max(1, self.SCORE_BLOCK_PAIRS // max(B, 1)))
        n_chunks = -(-T // chunk)
        if n_chunks * chunk > T:
            # pad the last chunk with its own last id
            item_ids = torch.cat([item_ids, item_ids[-1:].expand(n_chunks * chunk - T)])
        blocks = [self.score(params, user_ids.repeat_interleave(chunk),
                             item_ids[start:start + chunk].repeat(B)).reshape(B, chunk)
                  for start in range(0, n_chunks * chunk, chunk)]
        return torch.cat(blocks, dim=1)[:, :T] if n_chunks > 1 else blocks[0]

    @_whole_tables
    def get_item_predictions(self,
                             user_id: int = 0,
                             unseen_items_only: bool = False,
                             sort_values: bool = True) -> pd.Series:
        """Predicted scores for every item for one user
        (reference ``base_pipeline.py:656-718``)."""
        if user_id >= self.hparams['num_users']:
            raise ValueError(
                f'``user_id`` {user_id} is not in the model. Expected ID between ``0`` and '
                f'``{self.hparams["num_users"] - 1}``, not ``{user_id}``'
            )
        with torch.no_grad():
            scores = self.score_all_items(self.params, self._ids([user_id]))[0].cpu().numpy()
        preds = pd.Series(scores)
        if sort_values:
            preds = preds.sort_values(ascending=False)
        if unseen_items_only:
            seen = [self.train_loader.mat.tocsr()[user_id, :].nonzero()[1]]
            if self.val_loader is not None:
                seen.append(self.val_loader.mat.tocsr()[user_id, :].nonzero()[1])
            preds = preds.drop(np.concatenate(seen))
        return preds

    def get_user_predictions(self,
                             item_id: int = 0,
                             unseen_users_only: bool = False,
                             sort_values: bool = True) -> pd.Series:
        """User counterpart of ``get_item_predictions``
        (reference ``base_pipeline.py:720-783``)."""
        if item_id >= self.hparams['num_items']:
            raise ValueError(
                f'``item_id`` {item_id} is not in the model. Expected ID between ``0`` and '
                f'``{self.hparams["num_items"] - 1}``, not ``{item_id}``'
            )
        users = np.arange(self.hparams['num_users'])
        scores = self.forward(users, np.full_like(users, item_id))
        preds = pd.Series(scores)
        if sort_values:
            preds = preds.sort_values(ascending=False)
        if unseen_users_only:
            seen = [self.train_loader.mat.tocsr()[:, item_id].nonzero()[0]]
            if self.val_loader is not None:
                seen.append(self.val_loader.mat.tocsr()[:, item_id].nonzero()[0])
            preds = preds.drop(np.concatenate(seen))
        return preds

    @_whole_tables
    def item_item_similarity(self, item_id: int) -> pd.Series:
        """Most-similar items by cosine over item embeddings
        (reference ``base_pipeline.py:785-823``)."""
        if item_id >= self.hparams['num_items']:
            raise ValueError(
                f'``item_id`` {item_id} is not in the model. Expected ID between ``0`` and '
                f'``{self.hparams["num_items"] - 1}``, not ``{item_id}``'
            )
        return self._embedding_similarity(self._get_item_embeddings(), item_id)

    @_whole_tables
    def user_user_similarity(self, user_id: int) -> pd.Series:
        """Most-similar users by cosine over user embeddings
        (reference ``base_pipeline.py:825-864``)."""
        if user_id >= self.hparams['num_users']:
            raise ValueError(
                f'``user_id`` {user_id} is not in the model. Expected ID between ``0`` and '
                f'``{self.hparams["num_users"] - 1}``, not ``{user_id}``'
            )
        return self._embedding_similarity(self._get_user_embeddings(), user_id)

    @staticmethod
    def _embedding_similarity(embeddings: torch.Tensor, idx: int) -> pd.Series:
        embeddings = embeddings.float()  # bf16 tables: norm in f32
        emb = embeddings / torch.linalg.norm(embeddings, dim=1, keepdim=True)
        sims = emb[idx] @ emb.T
        return pd.Series(sims.cpu().numpy()).sort_values(ascending=False)

    def _get_item_embeddings(self) -> torch.Tensor:
        raise NotImplementedError(
            '``_get_item_embeddings`` is not implemented in this subclass.'
        )

    def _get_user_embeddings(self) -> torch.Tensor:
        raise NotImplementedError(
            '``_get_user_embeddings`` is not implemented in this subclass.'
        )

    # ------------------------------------------------------------ persistence

    @_whole_tables
    def save_model(self, filename: Union[str, Path] = 'model.npz') -> None:
        """Persist ``{params, hparams}`` to one ``.npz`` in the JAX package's
        format; no trainer or optimizer state (reference
        ``base_pipeline.py:880-900``).  A model that holds shards writes the
        whole tables; across processes every rank gathers, rank 0 writes
        and the call returns on every rank once the file is complete."""
        from collie_tpu_torch.parallel.distributed import barrier, is_multiprocess, process_index

        if process_index() == 0:
            self._write_npz(filename)
        if is_multiprocess():
            barrier()

    def _write_npz(self, filename: Union[str, Path]) -> None:
        # npz has no bfloat16: store bf16 tables upcast to float32 (lossless)
        # and let load re-apply hparams['embeddings_dtype']
        arrays = {
            f'param:{k}': (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in self.params.items()
        }
        if self.metadata_for_loss is not None:
            arrays.update({
                f'lossmeta:{k}': np.asarray(v) for k, v in self.metadata_for_loss.items()
            })
        arrays.update(self._extra_save_arrays())
        hparams_serializable = {
            k: v for k, v in self.hparams.items() if _json_safe(v)
        }
        hparams_serializable['_model_class'] = type(self).__name__
        arrays['hparams_json'] = np.frombuffer(
            json.dumps(hparams_serializable).encode(), dtype=np.uint8)
        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        np.savez(str(filename), **arrays)

    def _extra_save_arrays(self) -> Dict[str, np.ndarray]:
        """Hook for subclasses: more named arrays for the npz."""
        return {}

    def _load_model_init_helper(self, load_model_path: Union[str, Path], **kwargs) -> None:
        """Restore hparams and weights (reference ``base_pipeline.py:245-257``).
        The file's params replace a build, so none is made."""
        with np.load(str(load_model_path), allow_pickle=False) as loaded:
            hparams = json.loads(bytes(loaded['hparams_json']).decode())
            hparams.pop('_model_class', None)
            self.hparams.update(hparams)
            self.hparams['load_model_path'] = str(load_model_path)
            lossmeta = {
                k[len('lossmeta:'):]: np.array(loaded[k])
                for k in loaded.files if k.startswith('lossmeta:')
            }
            if lossmeta:
                self.metadata_for_loss = lossmeta
            self._restore_extra_arrays(loaded, **kwargs)
            self.load_params({
                k[len('param:'):]: torch.from_numpy(np.array(loaded[k]))
                for k in loaded.files if k.startswith('param:')
            })

    def _restore_extra_arrays(self, loaded, **kwargs) -> None:
        """Hook for subclasses to restore ``_extra_save_arrays``' arrays
        (``loaded`` is the open npz) before the params load."""


def _call_loss(loss_function, *args, **kwargs):
    """Call a loss that may not take the whole keyword surface: on a
    ``TypeError``, once more without ``sample_weights`` (the reference's
    ``_call_loss``, ``collie_tpu/models/base.py:899-906``)."""
    try:
        return loss_function(*args, **kwargs)
    except TypeError:
        kwargs.pop('sample_weights', None)
        return loss_function(*args, **kwargs)


def _as_array_dict(metadata):
    if metadata is None:
        return None
    return {k: np.asarray(v).reshape(-1) for k, v in metadata.items()}


def _json_safe(value) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
