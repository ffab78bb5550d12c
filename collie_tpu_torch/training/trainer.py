"""Training engine: one epoch function call per epoch, a host loop around it.

Port of ``collie_tpu/training/trainer.py`` for single-device in-memory
loaders of implicit or explicit data.  ``CollieTrainer.fit`` builds the
epoch functions of ``scan_engine`` once per fit and runs the per-epoch host
loop of the JAX package's ``_run_epochs`` (``:676-790``): the epoch call (a
fused kernel for an MF on ``cuda``: ``fused_mf_epoch`` for implicit data,
``fused_mf_explicit_epoch`` for ratings), the ``terminate_on_nan`` trip, the
validation loss,
host ``ReduceLROnPlateau`` / ``StepLR`` stepping through ``set_lr``, early
stopping on the monitored loss, ``num_epochs_completed`` and the verbose
lines.  The base seed is ``seed`` (0 when not given), as the JAX trainer's
``PRNGKey(seed)``.

Not ported yet (ROADMAP Queue 1): the whole-fit single dispatch (a CUDA
graph on this card), checkpoint/resume, the HDF5 chunk tier and the per-step
path, mesh training, multi-process fits and ``CollieMinimalTrainer``.
Asking for any of them raises ``NotImplementedError``.
"""
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from collie_tpu_torch.training.optimizers import get_lr, set_lr
from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns, loader_is_scannable
from collie_tpu_torch.training.schedulers import resolve_scheduler

_ROADMAP = 'not ported yet (ROADMAP Queue 1)'


class CollieTrainer:
    """Training engine driving a ``BasePipeline`` model."""

    def __init__(self,
                 model=None,
                 max_epochs: int = 10,
                 benchmark: bool = True,
                 deterministic: bool = True,
                 gpus: Optional[int] = None,
                 logger: Optional[Any] = None,
                 early_stopping_patience: Optional[int] = None,
                 log_every_n_steps: int = 50,
                 terminate_on_nan: bool = False,
                 verbosity: int = 1,
                 mesh: Optional[Any] = None,
                 epoch_mode: str = 'auto',
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_n_epochs: int = 1,
                 exact_sampling_dedup_rounds: int = 1,
                 enable_model_summary: bool = True,
                 seed: Optional[int] = None):
        assert epoch_mode in ('auto', 'scan', 'step'), epoch_mode
        if mesh is not None:
            raise NotImplementedError(f'mesh training is {_ROADMAP}')
        if checkpoint_dir is not None:
            raise NotImplementedError(f'checkpointing is {_ROADMAP}')
        if epoch_mode == 'step':
            raise NotImplementedError(f'the per-step path is {_ROADMAP}')
        self.max_epochs = max_epochs
        self.benchmark = benchmark
        self.deterministic = deterministic
        # Lightning idiom ``logger=False`` means no logger
        self.logger = logger or None
        self.early_stopping_patience = early_stopping_patience
        self.log_every_n_steps = log_every_n_steps
        self.terminate_on_nan = terminate_on_nan
        self.verbosity = verbosity
        self.mesh = mesh
        self.epoch_mode = epoch_mode
        self.seed = seed if seed is not None else 0
        self.global_step = 0
        self.best_epoch_loss: Tuple[int, float] = (-1, float('inf'))
        self.num_epochs_completed = 0
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_n_epochs = checkpoint_every_n_epochs
        self.enable_model_summary = enable_model_summary
        self.exact_sampling_dedup_rounds = exact_sampling_dedup_rounds
        #: training examples per second of the last ``fit``
        self.last_fit_examples_per_sec: Optional[float] = None
        #: per epoch of the last ``fit``: ``epoch``, ``seconds`` (host clock,
        #: validation included), ``shuffle_ms``, ``sample_ms`` (the sampler
        #: and the batch assembly; for explicit data, which has no sampler,
        #: the batch gather alone) and ``train_ms`` (the kernel, or the
        #: generic epoch's steps)
        self.epoch_log: List[Dict[str, float]] = []

    def resume_from_checkpoint(self, path) -> int:
        raise NotImplementedError(f'checkpoint/resume is {_ROADMAP}')

    # ------------------------------------------------------------------- fit

    def fit(self, model) -> None:
        specs = model.optimizer_specs()
        stage = model.current_stage
        active = [spec.stage is None or spec.stage == stage for spec in specs]
        params = dict(model.params)
        self._pre_fit_report(model, params, specs, active)

        if not loader_is_scannable(model.train_loader):
            raise NotImplementedError(
                f'training from {type(model.train_loader).__name__} (the per-step and HDF5 '
                f'paths) is {_ROADMAP}; use an in-memory InteractionsDataLoader')
        if model.val_loader is not None and not loader_is_scannable(model.val_loader):
            raise NotImplementedError(
                f'validation from {type(model.val_loader).__name__} is {_ROADMAP}')

        train_fn, train_data, _, train_examples = build_scan_epoch_fns(
            model, specs, active, model.train_loader,
            shuffle=getattr(model.train_loader, 'shuffle', True), training=True,
            dedup_rounds=self.exact_sampling_dedup_rounds)
        val_fn = val_data = None
        if model.val_loader is not None:
            val_fn, val_data, _, _ = build_scan_epoch_fns(
                model, specs, active, model.val_loader, shuffle=False, training=False)

        # optimizer state resets each fit (reference semantics)
        opt_states = tuple(spec.transform.init({k: params[k] for k in spec.keys})
                           for spec in specs)
        schedulers = [resolve_scheduler(model.lr_scheduler_func) for _ in specs]
        start_epoch = model.hparams.get('num_epochs_completed', 0) + 1
        self.epoch_log = []
        state = {'params': params, 'opt_states': opt_states, 'total_examples': 0}
        fit_start = time.perf_counter()
        try:
            self._run_epochs(model=model, specs=specs, schedulers=schedulers,
                             start_epoch=start_epoch, train_fn=train_fn,
                             train_data=train_data, train_examples=train_examples,
                             val_fn=val_fn, val_data=val_data, state=state)
        finally:
            # the model holds the latest tables even when an epoch raises
            model.load_params(state['params'])
        fit_secs = time.perf_counter() - fit_start
        self.last_fit_examples_per_sec = (state['total_examples'] / fit_secs
                                          if fit_secs > 0 else None)

    def _pre_fit_report(self, model, params, specs, active) -> None:
        """Model summary (name, shape, dtype, count, train/frozen) and
        hyperparameter logging at fit start."""
        if self.verbosity > 0 and self.enable_model_summary:
            trainable = set()
            for spec, is_active in zip(specs, active):
                if is_active:
                    trainable.update(spec.keys)
            rows = []
            for name in sorted(params):
                value = params[name]
                n = int(np.prod(tuple(value.shape))) if value.dim() else 1
                rows.append((name, str(tuple(value.shape)), str(value.dtype).replace('torch.', ''),
                             n, 'train' if name in trainable else 'frozen'))
            name_w = max([len(r[0]) for r in rows] + [4])
            shape_w = max([len(r[1]) for r in rows] + [5])
            print(f'  | {"Name":<{name_w}} | {"Shape":<{shape_w}} | '
                  f'{"Dtype":<8} | {"Params":>10} | Mode')
            for r in rows:
                print(f'  | {r[0]:<{name_w}} | {r[1]:<{shape_w}} | '
                      f'{r[2]:<8} | {r[3]:>10,} | {r[4]}')
            total = sum(r[3] for r in rows)
            n_train = sum(r[3] for r in rows if r[4] == 'train')
            print(f'  {n_train:,} trainable params | '
                  f'{total - n_train:,} frozen params | {total:,} total | '
                  f'stage: {model.current_stage or "-"}')
        if self.logger is not None:
            log_hp = getattr(self.logger, 'log_hyperparams', None)
            if callable(log_hp):
                log_hp(dict(model.hparams))
                save = getattr(self.logger, 'save', None)
                if callable(save):
                    save()

    def _run_epochs(self, *, model, specs, schedulers, start_epoch, train_fn, train_data,
                    train_examples, val_fn, val_data, state) -> None:
        monitor_val = val_fn is not None
        epochs_no_improvement = 0
        for epoch in range(start_epoch, self.max_epochs + 1):
            epoch_start = time.perf_counter()
            params, opt_states, loss = train_fn(state['params'], state['opt_states'],
                                                train_data, self.seed, epoch)
            train_loss = float(loss)
            state['params'], state['opt_states'] = params, opt_states
            state['total_examples'] += train_examples
            split = train_fn.split_ms()

            if self.terminate_on_nan and not np.isfinite(train_loss):
                raise FloatingPointError(f'NaN/Inf train loss at epoch {epoch}.')

            val_loss = None
            if monitor_val:
                val_loss = float(val_fn(params, val_data, self.seed, epoch))

            model.hparams['num_epochs_completed'] = epoch
            self.num_epochs_completed = epoch
            monitored = val_loss if monitor_val else train_loss
            epoch_secs = time.perf_counter() - epoch_start
            self.epoch_log.append({'epoch': epoch, 'seconds': epoch_secs, **split})
            if self.verbosity > 0:
                msg = f'Epoch {epoch:>3}: train loss {train_loss:.5f}'
                if val_loss is not None:
                    msg += f', val loss {val_loss:.5f}'
                msg += f' ({epoch_secs:.1f}s)'
                print(msg)
            if self.logger is not None:
                metrics = {'train_loss_epoch': train_loss}
                if val_loss is not None:
                    metrics['val_loss_epoch'] = val_loss
                self.logger.log_metrics(metrics, step=epoch)

            # lr schedulers (plateau-style on the monitored loss)
            new_states = list(state['opt_states'])
            for i, scheduler in enumerate(schedulers):
                if scheduler is None:
                    continue
                factor = scheduler.step(monitored)
                if factor is not None:
                    current = get_lr(new_states[i])
                    min_lr = getattr(scheduler, 'min_lr', 0.0)
                    new_states[i] = set_lr(new_states[i], max(current * factor, min_lr))
                    if self.verbosity > 0:
                        print(f'  lr[{specs[i].name}] -> {max(current * factor, min_lr):.2e}')
            state['opt_states'] = tuple(new_states)

            # early stopping on the best epoch loss
            if monitored < self.best_epoch_loss[1]:
                self.best_epoch_loss = (epoch, monitored)
                epochs_no_improvement = 0
            else:
                epochs_no_improvement += 1
                if (self.early_stopping_patience is not None
                        and epochs_no_improvement >= self.early_stopping_patience):
                    if self.verbosity > 0:
                        print(f'Early stopping at epoch {epoch} '
                              f'(best epoch {self.best_epoch_loss[0]}, '
                              f'loss {self.best_epoch_loss[1]:.5f}).')
                    break


class CollieMinimalTrainer(CollieTrainer):
    """The reference's hand-rolled loop; in the JAX package an alias of
    ``CollieTrainer``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'CollieMinimalTrainer is {_ROADMAP}; use CollieTrainer')
