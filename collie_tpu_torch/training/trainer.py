"""Training engine: the whole fit, or one epoch function call per epoch.

Port of ``collie_tpu/training/trainer.py`` for fits of implicit or
explicit data on one device or a mesh.  ``CollieTrainer.fit`` has three tiers, chosen as
JAX chooses them (``:196-222``, ``:465-499``, ``:682-692``):

* the whole fit (``_run_fit_scan``, the default): when the loaders are
  in-memory, no ``checkpoint_dir`` is set, every scheduler has a device
  form (``schedulers.scheduler_device_config``) and every optimizer a
  scheduler acts on keeps a ``learning_rate``, the epochs run in greedy
  power-of-two blocks of at most 16 (``scan_engine.build_scan_fit_fn``)
  with the schedulers, early stopping and the NaN trip on the device, and
  the host waits for the card once per flight of up to 4 blocks: one
  transfer of the flight's losses, learning rates, ``ran`` mask and the
  scheduler and early-stopping state.  Then it replays the per-epoch
  bookkeeping: prints (JAX's format, without per-epoch seconds), logger
  rows, learning-rate changes, ``best_epoch_loss``, the epoch counters, the
  ``FloatingPointError`` of the NaN trip and the early-stopping message.
  The blocks cost nothing to build here; they are kept so that the host
  sees a stop at the epochs where JAX's does.  ``COLLIE_TPU_WHOLE_FIT=0``
  takes the per-epoch loop instead, and so does every fit outside those
  conditions;
* the per-epoch host loop of the JAX package's ``_run_epochs``
  (``:762-869``), over one of three epoch paths:

* the whole-epoch path (``scan_engine``) for in-memory loaders, unless
  ``epoch_mode='step'``: the epoch functions are built once per fit, and an
  MF on ``cuda`` trains through a fused kernel (``fused_mf_epoch`` for
  implicit data, ``fused_mf_explicit_epoch`` for ratings);
* the out-of-core chunk tier (``_hdf5_chunk_epoch``) for an
  ``HDF5InteractionsDataLoader`` (JAX's rule, ``:191-221``: not
  ``epoch_mode='step'``, ``COLLIE_TPU_HDF5_CHUNK_STEPS`` > 0, default 64):
  the epoch's steps in chunks (``scan_engine.hdf5_chunk_plan``), in the
  loader's chunk order, each chunk read from the store on a background
  thread one chunk ahead, copied to the device from pinned host memory
  without a sync and trained by one chunk function
  (``scan_engine.build_hdf5_chunk_make``); the host reads the epoch's loss
  once, at its end;
* the per-step path for ``epoch_mode='step'`` and for any loader the
  whole-epoch path cannot take (a ``PrefetchLoader``, a custom iterable of
  batch dicts): each numpy batch of the loader's host iterator goes to the
  device and through one ``scan_engine.train_step``.  JAX groups such steps
  into ``lax.scan`` chunks (``COLLIE_TPU_STEP_SCAN_GROUP``), a TPU dispatch
  device that changes no value; here the steps run one by one, each with
  the dropout seed of its global step (``step_dropout_seed``, the analog of
  ``fold_in(PRNGKey(seed), step)``).  ``global_step`` counts these steps
  (and the chunk tier's) and ``train_loss_step`` is logged every
  ``log_every_n_steps``; the whole-epoch path leaves ``global_step``
  alone, as JAX's does.  Validation
  from a loader the whole-epoch path cannot take is the mean of per-batch
  losses.

Around the epoch: the ``terminate_on_nan`` trip, the validation loss, host
``ReduceLROnPlateau`` / ``StepLR`` stepping through ``set_lr`` (the new
rate in float32, as the device step computes it), checkpoints, early
stopping on the monitored loss, ``num_epochs_completed`` and the verbose
lines.  The base seed is ``seed`` (0 when not given), as the JAX
trainer's ``PRNGKey(seed)``.

Checkpoints (``:104-157``, the host-pickle format): with ``checkpoint_dir``,
``checkpoint_epoch_<n>.pkl`` every ``checkpoint_every_n_epochs`` epochs,
published through a ``.tmp`` file and a rename, with JAX's keys
(``params``, ``opt_states``, ``schedulers``, ``epoch``, ``global_step``,
``best_epoch_loss``).  Every array is a host numpy array (bfloat16 as its
bit pattern, ``weights.host_leaf``), so a checkpoint written on the card
loads on a host without one; an optimizer state is stored as the list of
its leaves in a fixed order and a scheduler as its attributes.
``resume_from_checkpoint`` reads such a file, or one the JAX package wrote
(``weights.read_checkpoint``), and arms the next ``fit`` with the whole
state.

``flight_guard``: the context the whole fit enters around each flight's
dispatch, and the chunk tier around an epoch's chunk loop (none by
default); ``chip_smoke.py`` sets one that turns every host sync inside
them into an error.

Mesh training (``mesh=``, a ``parallel.make_mesh`` mesh; JAX ``:64,
84, 104-178, 313-365``): SPMD, every rank calling ``fit`` with the same
arguments on the same data (checked by a fingerprint at fit start when
there are several processes; ranks other than 0 print nothing).  The
model's params are split by ``parallel.sharding.train_param_spec`` (tables
read by id row-sharded over ``model``, the rest whole) and the optimizer
states built on the shards (``init_sharded_opt_states``); all three tiers
run on the mesh, the epochs through the generic epoch's mesh step
(``scan_engine.build_scan_epoch_fns``) and the per-step path through
``shard_batch_fn`` (a batch that does not divide ``data`` padded with
mask-0 rows).  The whole fit checks at the end of each flight that every
rank took the same decisions (losses, learning rates, the stop).  With a
``checkpoint_dir`` a mesh fit writes ``checkpoint_epoch_<n>.shards``
directories (``parallel.checkpoint``), which ``resume_from_checkpoint``
takes, from either package, on any mesh or on one device.  The
out-of-core chunk tier is off under a mesh, as in JAX: at world size 1 an
HDF5 loader takes the per-step path, above it the fit raises JAX's
multi-process message (JAX refuses every loader but the in-memory one
across processes; here each rank reads the same loader and takes its rows,
so the per-step path runs on any mesh).  After the fit the model holds its shards
(``BasePipeline.load_shards``).
"""
import contextlib
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from collie_tpu_torch.data import HDF5InteractionsDataLoader
from collie_tpu_torch.training.optimizers import (get_lr, host_scalars, set_lr,
                                                  state_from_leaves, state_from_tree,
                                                  state_leaves, state_paths, state_tree,
                                                  whole_fit_states)
from collie_tpu_torch.training.profiler import annotate
from collie_tpu_torch.training.scan_engine import (build_hdf5_chunk_make, build_scan_epoch_fns,
                                                   build_scan_fit_fn, device_stamp,
                                                   fetch_to_host, hdf5_chunk_plan,
                                                   loader_is_scannable, mesh_leaves, stamps_ms,
                                                   train_step)
from collie_tpu_torch.training.schedulers import (resolve_scheduler,
                                                  scheduler_absorb_device_state,
                                                  scheduler_device_config, scaled_lr)
from collie_tpu_torch.weights import (device_leaf, host_leaf, optimizer_state_from_jax,
                                      read_checkpoint)

#: blocks of a whole fit dispatched between two host syncs
_FLIGHT = 4
#: the longest block of a whole fit
_MAX_BLOCK = 16

#: entered around each flight's dispatch and each chunk loop (module docstring)
flight_guard = contextlib.nullcontext


def step_dropout_seed(seed: int, global_step: int, data_index: int = 0) -> int:
    """The dropout seed of one per-step-path step, from ``(seed,
    global_step)``; a mesh's ``data`` rank ``data_index`` > 0 mixes its
    index in (``scan_engine.dropout_step_seeds``)."""
    entropy = [int(seed), int(global_step), 4] + ([int(data_index)] if data_index else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, dtype=np.uint64)[0])


def _leaf_key(path) -> Optional[str]:
    """The innermost dict key on a checkpoint leaf's path."""
    return next((entry for entry in reversed(path) if isinstance(entry, str)), None)


def hdf5_epoch_extent(loader) -> Tuple[int, int]:
    """``(real steps, rows used)`` of one epoch over an
    ``HDF5InteractionsDataLoader``: with ``drop_last`` the partial last
    batch's rows are left out."""
    n, B = loader.num_interactions, loader.batch_size
    if getattr(loader, 'drop_last', False):
        return n // B, (n // B) * B
    return -(-n // B), n


def read_hdf5_chunk(loader, start_step: int, steps: int, n_used: int,
                    device: torch.device) -> List[torch.Tensor]:
    """A chunk's ``[users, items, mask]`` as host tensors of
    ``steps * batch_size`` rows (pinned when ``device`` is a card), the rows
    of the store from step ``start_step`` on, the tail past ``n_used``
    padded with id 0 and mask 0."""
    B = loader.batch_size
    start = start_step * B
    stop = min(start + steps * B, n_used)
    users, items = loader.interactions.read_chunk(start, stop)
    out = [torch.zeros(steps * B, dtype=dtype, pin_memory=device.type == 'cuda')
           for dtype in (torch.int32, torch.int32, torch.float32)]
    real = stop - start
    out[0][:real] = torch.from_numpy(users)
    out[1][:real] = torch.from_numpy(items)
    out[2][:real] = 1.0
    return out


def hdf5_chunk_to_device(host: List[torch.Tensor], device: torch.device):
    """``read_hdf5_chunk``'s tensors on ``device``, copied without a host
    sync."""
    return tuple(t.to(device, non_blocking=True) for t in host)


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
        self._pending_resume: Optional[Dict[str, Any]] = None
        #: under a mesh, the fit's ``train_param_spec`` of every param
        self._specs: Optional[Dict[str, tuple]] = None
        #: training examples per second of the last ``fit``
        self.last_fit_examples_per_sec: Optional[float] = None
        #: per epoch of the last ``fit``: ``epoch``, ``seconds`` (validation
        #: included; the host clock, or in a whole fit the span from the
        #: epoch's start to the next one's on the device's timeline, CUDA
        #: events on the card) and, on the whole-epoch path, ``shuffle_ms``,
        #: ``sample_ms`` (the sampler and the batch assembly; for explicit
        #: data, which has no sampler, the batch gather alone) and
        #: ``train_ms`` (the kernel, or the generic epoch's steps); on the
        #: per-step path, ``steps``
        self.epoch_log: List[Dict[str, float]] = []

    # ---------------------------------------------------------- checkpoints

    def _write_checkpoint(self, params, opt_states, schedulers, epoch: int) -> None:
        from collie_tpu_torch.parallel import distributed

        Path(self.checkpoint_dir).mkdir(parents=True, exist_ok=True)
        host_payload = {
            'schedulers': [None if s is None else dict(vars(s)) for s in schedulers],
            'epoch': epoch,
            'global_step': self.global_step,
            'best_epoch_loss': self.best_epoch_loss,
        }
        if self.mesh is not None or distributed.is_multiprocess():
            # per-shard format (JAX ``:104-126``): each process writes only
            # the shards it owns, so no full table is ever gathered
            from collie_tpu_torch.parallel.checkpoint import save_sharded_pytree
            path = Path(self.checkpoint_dir) / f'checkpoint_epoch_{epoch}.shards'
            local = {k: tuple(v.shape) for k, v in params.items()}
            save_sharded_pytree(
                path, {'params': dict(params),
                       'opt_states': tuple(state_tree(host_scalars(s)) for s in opt_states)},
                host_payload, mesh=self.mesh,
                specs=lambda leaf_path, leaf: self._leaf_spec(leaf_path, tuple(leaf.shape),
                                                              local))
            if self.verbosity > 1:
                print(f'  checkpoint -> {path}')
            return
        payload = {
            'params': {k: host_leaf(v) for k, v in params.items()},
            'opt_states': tuple([host_leaf(leaf) for leaf in state_leaves(host_scalars(state))]
                                for state in opt_states),
            **host_payload,
        }
        path = Path(self.checkpoint_dir) / f'checkpoint_epoch_{epoch}.pkl'
        tmp = path.with_suffix('.tmp')
        with open(tmp, 'wb') as f:
            pickle.dump(payload, f)
        tmp.rename(path)  # atomic publish: readers never see partial files
        if self.verbosity > 1:
            print(f'  checkpoint -> {path}')

    def _leaf_spec(self, path, shape, shapes) -> tuple:
        """The spec of a checkpoint leaf at ``path``: a param's, or a moment's
        of the param whose dict key it sits under when it has that param's
        ``shape`` in ``shapes`` (JAX's rule, ``make_sharded_init``), else
        replicated."""
        key = _leaf_key(path)
        if self.mesh is None or key not in shapes or tuple(shape) != shapes[key]:
            return ()
        return self._specs[key]

    def resume_from_checkpoint(self, path) -> int:
        """Arm the next ``fit`` call to restore the full training state
        (parameters, optimizer moments and learning rates, scheduler and
        early-stopping state, epoch and step counters) from a checkpoint
        written by either package: a ``checkpoint_epoch_<n>.pkl`` or a
        per-shard ``.shards`` directory (read at ``fit`` time, each rank
        reading its shards of the fit's layout, whatever mesh wrote it).
        Returns the checkpoint's epoch."""
        from collie_tpu_torch.parallel.checkpoint import is_sharded_checkpoint, read_meta

        if is_sharded_checkpoint(path):
            epoch = read_meta(path)['host_payload']['epoch']
            self._pending_resume = {'sharded_path': str(path), 'epoch': epoch}
            return epoch
        self._pending_resume = read_checkpoint(path)
        return self._pending_resume['epoch']

    def _read_sharded(self, path, params) -> Dict[str, Any]:
        """A ``.shards`` checkpoint as ``read_checkpoint``'s payload, every
        array this rank's shard of the fit's layout."""
        from collie_tpu_torch.parallel.checkpoint import load_sharded_pytree
        from collie_tpu_torch.parallel.sharding import global_shape

        shapes = {k: (global_shape(v.shape, self.mesh, self._specs[k]) if self.mesh is not None
                      else tuple(v.shape)) for k, v in params.items()}
        tree, host_payload = load_sharded_pytree(
            path, lambda leaf_path, shape: self._leaf_spec(leaf_path, shape, shapes), self.mesh)
        return {'params': tree['params'], 'opt_states': tree['opt_states'], **host_payload}

    def _restore(self, model, ckpt, opt_states, schedulers):
        """The state a checkpoint holds, on the model's device: ``(params,
        opt_states, schedulers)``; the counters go to the model and the
        trainer.  ``opt_states`` and ``schedulers`` are the fit's fresh ones,
        whose structure a port checkpoint's leaves fill."""
        device = model.device
        params = {k: device_leaf(v, device) for k, v in ckpt['params'].items()}
        restored = []
        for saved, fresh in zip(ckpt['opt_states'], opt_states):
            if hasattr(saved, 'hyperparams'):      # an optax state of the JAX package
                restored.append(optimizer_state_from_jax(saved, device))
            elif isinstance(saved, dict):          # a .shards state of the port
                tree = state_from_tree(fresh, saved)
                restored.append(state_from_leaves(
                    fresh, iter([device_leaf(leaf, device) for leaf in state_leaves(tree)])))
            else:
                leaves = iter([device_leaf(leaf, device) for leaf in saved])
                restored.append(state_from_leaves(fresh, leaves))
        new_schedulers = []
        for saved, fresh in zip(ckpt['schedulers'], schedulers):
            if isinstance(saved, dict):
                fresh.__dict__.update(saved)
                saved = fresh
            new_schedulers.append(saved)
        model.hparams['num_epochs_completed'] = ckpt['epoch']
        self.global_step = ckpt['global_step']
        self.best_epoch_loss = tuple(ckpt['best_epoch_loss'])
        return params, tuple(restored), new_schedulers

    # ------------------------------------------------------------------- fit

    def _check_mesh(self, model) -> None:
        """The multi-process preamble (JAX ``:159-178``): a mesh spanning the
        processes, narration from rank 0 only, and the same data on every
        rank; and the model on the mesh's device."""
        from collie_tpu_torch.parallel import distributed

        if distributed.is_multiprocess():
            if self.mesh is None:
                raise ValueError(
                    'multi-process training requires a mesh spanning all '
                    'processes (collie_tpu_torch.parallel.make_mesh()).')
            if distributed.process_index() != 0:
                self.verbosity = 0
            for tag, loader in (('train data', model.train_loader),
                                ('val data', model.val_loader)):
                if loader is None:
                    continue
                try:
                    mat = loader.interactions.mat.tocoo()
                except (AttributeError, NotImplementedError):
                    continue    # out-of-core loaders are refused below
                distributed.assert_same_across_processes(tag, mat.row, mat.col, mat.data)
        if self.mesh is not None:
            from collie_tpu_torch.parallel.mesh import mesh_device

            device = mesh_device(self.mesh)
            if model.device.type != device.type or (
                    device.index is not None and model.device.index != device.index):
                raise ValueError(f'the model is on {model.device}, this rank of the mesh on '
                                 f'{device}: build the model after make_mesh, on its device')

    def _fit_params(self, model) -> Dict[str, torch.Tensor]:
        """The params the fit starts from: the whole tables without a mesh;
        under one this rank's shards by ``train_param_spec`` (``self._specs``),
        taken as the model holds them when it holds exactly those."""
        if self.mesh is None:
            self._specs = None
            return dict(model.whole_params())
        from collie_tpu_torch.parallel.distributed import put_global
        from collie_tpu_torch.parallel.sharding import train_param_shardings

        self._specs = train_param_shardings(model.global_shapes(), self.mesh, model.hparams)
        layout = model.param_layout()
        if layout is not None and layout[0] is self.mesh and layout[1] == self._specs:
            return dict(model.params)
        return {k: put_global(v, self.mesh, self._specs[k])
                for k, v in model.whole_params().items()}

    def _shard_restored(self, params, opt_states, whole_shapes):
        """A whole-table checkpoint's state split to this rank's shards."""
        from collie_tpu_torch.parallel.distributed import put_global

        params = {k: put_global(v, self.mesh, self._specs[k]) for k, v in params.items()}
        states = []
        for state in opt_states:
            leaves = [put_global(leaf, self.mesh, self._leaf_spec(path, tuple(leaf.shape),
                                                                  whole_shapes))
                      if torch.is_tensor(leaf) and leaf.dim() else leaf
                      for path, leaf in state_paths(state)]
            states.append(state_from_leaves(state, iter(leaves)))
        return params, tuple(states)

    def fit(self, model) -> None:
        with annotate('collie.fit'):
            with annotate('collie.fit.setup'):
                run = self._fit_setup(model)
            state = run['state']
            fit_start = time.perf_counter()
            # the finish span opens in the ``finally`` and closes after the
            # bookkeeping below it
            with contextlib.ExitStack() as finish:
                try:
                    with annotate('collie.fit.epochs'):
                        self._run_epochs(model=model, **run)
                finally:
                    finish.enter_context(annotate('collie.fit.finish'))
                    # the model holds the latest tables (its shards under a
                    # mesh) even when an epoch raises
                    if self.mesh is not None:
                        model.load_shards(state['params'], self.mesh, self._specs)
                    else:
                        model.load_params(state['params'])
                fit_secs = time.perf_counter() - fit_start
                self.last_fit_examples_per_sec = (state['total_examples'] / fit_secs
                                                  if fit_secs > 0 else None)

    def _fit_setup(self, model) -> Dict[str, Any]:
        """Everything a fit does before its epochs: the mesh checks, the
        params, the epoch tables or step functions, the report, the optimizer
        and scheduler states (restored from a pending resume).  Returns
        ``_run_epochs``' arguments but the model."""
        from collie_tpu_torch.parallel import distributed

        self._check_mesh(model)
        specs = model.optimizer_specs()
        stage = model.current_stage
        active = [spec.stage is None or spec.stage == stage for spec in specs]
        shapes = model.global_shapes()
        params = self._fit_params(model)

        use_scan_train = (self.epoch_mode != 'step'
                          and loader_is_scannable(model.train_loader))
        use_scan_val = (model.val_loader is not None and self.epoch_mode != 'step'
                        and loader_is_scannable(model.val_loader))
        # the out-of-core chunk tier; COLLIE_TPU_HDF5_CHUNK_STEPS=0 sends an
        # HDF5 loader down the per-step path
        hdf5_chunk_steps = int(os.environ.get('COLLIE_TPU_HDF5_CHUNK_STEPS', '64'))
        # the chunk tier is off under a mesh (JAX ``:205-209``)
        use_hdf5_train = (not use_scan_train and self.epoch_mode != 'step'
                          and self.mesh is None and hdf5_chunk_steps > 0
                          and isinstance(model.train_loader, HDF5InteractionsDataLoader))
        if self.epoch_mode == 'scan' and not use_scan_train:
            raise ValueError(
                'epoch_mode="scan" requires an in-memory InteractionsDataLoader '
                '(HDF5/out-of-core and custom loaders must use the per-step path).'
            )
        # JAX refuses every loader but the in-memory one across processes
        # (``:215-221``), its per-step path being single-host; the port's
        # ranks each read the same loader and take their rows, so only the
        # out-of-core loaders, which stream one store, are refused
        if distributed.is_multiprocess() and any(
                isinstance(loader, HDF5InteractionsDataLoader)
                for loader in (model.train_loader, model.val_loader)):
            raise ValueError(
                'multi-process training supports in-memory '
                'InteractionsDataLoaders only (the whole-epoch scan path); '
                'HDF5/out-of-core loaders are single-process.')
        self._device_put_loss_metadata(model)

        train_fn = train_data = val_fn = val_data = None
        train_examples = 0
        if use_scan_train:
            with annotate('collie.fit.epoch_tables'):
                train_fn, train_data, _, train_examples = build_scan_epoch_fns(
                    model, specs, active, model.train_loader,
                    shuffle=getattr(model.train_loader, 'shuffle', True), mesh=self.mesh,
                    training=True, dedup_rounds=self.exact_sampling_dedup_rounds)
        if use_scan_val:
            with annotate('collie.fit.epoch_tables'):
                val_fn, val_data, _, _ = build_scan_epoch_fns(
                    model, specs, active, model.val_loader, shuffle=False, mesh=self.mesh,
                    training=False)
        hdf5 = None
        if use_hdf5_train:
            with annotate('collie.fit.epoch_tables'):
                hdf5 = {'make': build_hdf5_chunk_make(
                            model, specs, active, model.train_loader,
                            shuffle=getattr(model.train_loader, 'shuffle', False)),
                        'fns': {}, 'chunk_steps': hdf5_chunk_steps}
        steps = None
        if (not use_scan_train and not use_hdf5_train) \
                or (model.val_loader is not None and not use_scan_val):
            steps = self._build_steps(model, specs, active)
        self._pre_fit_report(model, shapes, specs, active, train_fn, hdf5 is not None)

        # optimizer state resets each fit (reference semantics); under a
        # mesh the moments sit beside their params' shards
        from collie_tpu_torch.parallel.sharding import init_sharded_opt_states
        with annotate('collie.fit.opt_states'):
            opt_states = init_sharded_opt_states(specs, params, self.mesh)
            schedulers = [resolve_scheduler(model.lr_scheduler_func) for _ in specs]
            if self._pending_resume is not None:
                ckpt, self._pending_resume = self._pending_resume, None
                whole = 'sharded_path' not in ckpt
                if not whole:
                    ckpt = self._read_sharded(ckpt['sharded_path'], params)
                params, opt_states, schedulers = self._restore(model, ckpt, opt_states,
                                                               schedulers)
                if whole and self.mesh is not None:
                    params, opt_states = self._shard_restored(params, opt_states, shapes)
        start_epoch = model.hparams.get('num_epochs_completed', 0) + 1
        whole_fit = self._whole_fit_eligible(use_scan_train, use_scan_val,
                                             model.val_loader is not None, schedulers,
                                             opt_states)
        self.epoch_log = []
        return dict(specs=specs, schedulers=schedulers, start_epoch=start_epoch,
                    train_fn=train_fn, train_data=train_data, train_examples=train_examples,
                    val_fn=val_fn, val_data=val_data,
                    state={'params': params, 'opt_states': opt_states, 'total_examples': 0},
                    steps=steps, hdf5=hdf5, whole_fit=whole_fit)

    def _pre_fit_report(self, model, shapes, specs, active, train_fn=None,
                        hdf5: bool = False) -> None:
        """Model summary (name, shape, dtype, count, train/frozen), the
        training route (the epoch path; for implicit data the form of
        ``calculate_loss``, ``sparse`` or ``dense``, and its selection
        pass's precision, ``bf16`` or ``f32``; the table layout, ``fused``
        or ``named``) and hyperparameter logging at fit start."""
        if self.verbosity > 0 and self.enable_model_summary:
            trainable = set()
            for spec, is_active in zip(specs, active):
                if is_active:
                    trainable.update(spec.keys)
            rows = []
            dtypes = {name: value.dtype for name, value in model.params.items()}
            for name in sorted(shapes):
                shape = tuple(shapes[name])
                rows.append((name, str(shape), str(dtypes[name]).replace('torch.', ''),
                             int(np.prod(shape)) if shape else 1,
                             'train' if name in trainable else 'frozen'))
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
            print(f'  route: {self._route(model, train_fn, hdf5)}')
        if self.logger is not None:
            log_hp = getattr(self.logger, 'log_hyperparams', None)
            if callable(log_hp):
                log_hp(dict(model.hparams))
                save = getattr(self.logger, 'save', None)
                if callable(save):
                    save()

    @staticmethod
    def _route(model, train_fn, hdf5: bool = False) -> str:
        """``epoch: <path> | loss: <form>, <precision> | tables: <layout>``."""
        if hdf5:
            epoch = 'hdf5 chunks'
        elif train_fn is None:
            epoch = 'per-step'
        else:
            epoch = 'fused kernel' if train_fn.fused else 'generic'
        parts = [f'epoch: {epoch}']
        if model.hparams.get('_is_implicit') and not (train_fn and train_fn.fused):
            num_negatives = getattr(model.train_loader, 'num_negative_samples', 1)
            parts.append(f'loss: {model.selection_route(num_negatives)}, '
                         f'{model.selection_precision()} selection')
        tables = 'fused' if train_fn is not None and getattr(train_fn, 'fused_tables', False) \
            else 'named'
        return ' | '.join(parts + [f'tables: {tables}'])

    # ------------------------------------------------------------ whole fit

    def _whole_fit_eligible(self, use_scan_train, use_scan_val, monitor_val, schedulers,
                            opt_states) -> bool:
        """Whether the fit runs as a whole fit (module docstring), JAX's
        rule (``collie_tpu/training/trainer.py:465-499``).  A scheduler on
        a custom factory's state without a ``learning_rate`` routes the fit
        to the per-epoch loop, which fails only if that scheduler fires."""
        if os.environ.get('COLLIE_TPU_WHOLE_FIT', '1') == '0':
            return False
        if not use_scan_train or (monitor_val and not use_scan_val):
            return False
        if self.checkpoint_dir is not None:
            return False
        kinds = [scheduler_device_config(s, 'cpu') for s in schedulers]
        if any(k is None for k in kinds):
            return False
        return all(k[0] == 'none' or hasattr(state, 'learning_rate')
                   for k, state in zip(kinds, opt_states))

    def _run_fit_scan(self, *, model, specs, schedulers, start_epoch, train_fn, train_data,
                      train_examples, val_fn, val_data, state) -> None:
        """The whole fit: blocks of epochs dispatched in flights with one
        host transfer each, then the host-side replay of the per-epoch
        bookkeeping from the returned losses, learning rates and ``ran``
        mask (``collie_tpu/training/trainer.py:500-676``)."""
        num_epochs = self.max_epochs - start_epoch + 1
        if num_epochs <= 0:
            return
        device = model.device
        monitor_val = model.val_loader is not None
        cfgs = [scheduler_device_config(s, device) for s in schedulers]
        kinds = [c[0] for c in cfgs]
        sched_state = tuple(c[2] for c in cfgs)
        fit_fn = build_scan_fit_fn(train_fn, val_fn, monitor_val=monitor_val,
                                   sched_kinds=kinds, sched_statics=[c[1] for c in cfgs],
                                   es_patience=self.early_stopping_patience,
                                   terminate_on_nan=self.terminate_on_nan)
        # the lr-change replay starts from the pre-fit rates, so a cut on the
        # first epoch prints as in the per-epoch loop
        prev_lrs = [get_lr(st) if kind != 'none' else None
                    for kind, st in zip(kinds, state['opt_states'])]
        state['opt_states'] = whole_fit_states(state['opt_states'],
                                               [kind != 'none' for kind in kinds], device)
        blocks, remaining = [], num_epochs
        while remaining:
            b = _MAX_BLOCK
            while b > remaining:
                b //= 2
            blocks.append(b)
            remaining -= b
        es_state = (torch.full((), self.best_epoch_loss[1], dtype=torch.float32, device=device),
                    torch.zeros((), dtype=torch.int32, device=device),
                    torch.zeros((), dtype=torch.bool, device=device),
                    torch.zeros((), dtype=torch.bool, device=device))
        tl, vl, lrs, ran, log = [], [], [[] for _ in specs], [], []
        epoch = start_epoch
        for f0 in range(0, len(blocks), _FLIGHT):
            pending, marks = [], []
            with flight_guard():
                for b in blocks[f0:f0 + _FLIGHT]:
                    (state['params'], state['opt_states'], sched_state, es_state, *out) = fit_fn(
                        state['params'], state['opt_states'], train_data, val_data, self.seed,
                        range(epoch, epoch + b), sched_state, es_state, marks=marks)
                    pending.append(out)
                    epoch += b
                marks.append(device_stamp(device))
            # ONE host transfer for the flight: every block's outputs and the
            # scheduler and early-stopping state
            tensors = [t for tl_b, vl_b, lrs_b, ran_b in pending
                       for t in (tl_b, vl_b, *lrs_b, ran_b)]
            tensors += list(es_state) + [t for st in sched_state for t in st]
            host = iter(fetch_to_host(tensors))
            for _ in pending:
                tl.append(next(host))
                vl.append(next(host))
                for per_spec in lrs:
                    per_spec.append(next(host))
                ran.append(next(host))
            es_h = [next(host) for _ in es_state]
            sched_h = [tuple(next(host) for _ in st) for st in sched_state]
            if self.mesh is not None:
                # every rank decided from the same global losses: check it
                from collie_tpu_torch.parallel.distributed import assert_same_across_processes
                assert_same_across_processes(
                    'the whole fit\'s losses, learning rates and stop',
                    *tl[-len(pending):], *vl[-len(pending):],
                    *[a for per in lrs for a in per[-len(pending):]], *ran[-len(pending):],
                    *es_h)
            seconds = [ms / 1e3 for ms in stamps_ms(marks)]
            splits = train_fn.split_ms(epochs=len(seconds))
            log += [{'seconds': sec, **split} for sec, split in zip(seconds, splits)]
            if es_h[2]:                               # stopped: early stop or NaN
                break
        for scheduler, st in zip(schedulers, sched_h):
            scheduler_absorb_device_state(scheduler, st)
        self._replay(model, specs, kinds, start_epoch, train_examples, state, monitor_val,
                     np.concatenate(tl), np.concatenate(vl),
                     [np.concatenate(per) for per in lrs], np.concatenate(ran), log,
                     prev_lrs, es_h)

    def _replay(self, model, specs, kinds, start_epoch, train_examples, state, monitor_val,
                tl, vl, lrs, ran, log, prev_lrs, es_h) -> None:
        """The per-epoch loop's bookkeeping for each epoch a whole fit ran."""
        for j in range(len(tl)):
            if not ran[j]:
                break
            epoch = start_epoch + j
            train_loss = float(tl[j])
            val_loss = float(vl[j]) if monitor_val else None
            monitored = val_loss if monitor_val else train_loss
            # the per-epoch loop raises before counting the NaN epoch as
            # completed, after its examples were processed
            state['total_examples'] += train_examples
            if self.terminate_on_nan and not np.isfinite(train_loss):
                raise FloatingPointError(f'NaN/Inf train loss at epoch {epoch}.')
            model.hparams['num_epochs_completed'] = epoch
            self.num_epochs_completed = epoch
            self.epoch_log.append({'epoch': epoch, **log[j]})
            if self.verbosity > 0:
                msg = f'Epoch {epoch:>3}: train loss {train_loss:.5f}'
                if val_loss is not None:
                    msg += f', val loss {val_loss:.5f}'
                print(msg)
            if self.logger is not None:
                metrics = {'train_loss_epoch': train_loss}
                if val_loss is not None:
                    metrics['val_loss_epoch'] = val_loss
                self.logger.log_metrics(metrics, step=epoch)
            for i, kind in enumerate(kinds):
                if kind == 'none':
                    continue
                lr_now = float(lrs[i][j])
                if lr_now != prev_lrs[i] and self.verbosity > 0:
                    print(f'  lr[{specs[i].name}] -> {lr_now:.2e}')
                prev_lrs[i] = lr_now
            if monitored < self.best_epoch_loss[1]:
                self.best_epoch_loss = (epoch, monitored)
        if es_h[3]:
            # the replay above raises first; kept as JAX keeps it
            raise FloatingPointError('NaN/Inf train loss during fit.')
        if es_h[2] and self.verbosity > 0:
            print(f'Early stopping at epoch {self.num_epochs_completed} '
                  f'(best epoch {self.best_epoch_loss[0]}, '
                  f'loss {self.best_epoch_loss[1]:.5f}).')

    # -------------------------------------------------------- per-epoch loop

    def _run_epochs(self, *, model, specs, schedulers, start_epoch, train_fn, train_data,
                    train_examples, val_fn, val_data, state, steps=None, hdf5=None,
                    whole_fit: bool = False) -> None:
        if whole_fit:
            self._run_fit_scan(model=model, specs=specs, schedulers=schedulers,
                               start_epoch=start_epoch, train_fn=train_fn,
                               train_data=train_data, train_examples=train_examples,
                               val_fn=val_fn, val_data=val_data, state=state)
            return
        monitor_val = model.val_loader is not None
        epochs_no_improvement = 0
        for epoch in range(start_epoch, self.max_epochs + 1):
            epoch_start = time.perf_counter()
            if train_fn is not None:
                params, opt_states, loss = train_fn(state['params'], state['opt_states'],
                                                    train_data, self.seed, epoch)
                with annotate('collie.sync'):
                    train_loss = float(loss)
                state['total_examples'] += train_examples
                split = train_fn.split_ms()
            elif hdf5 is not None:
                step0 = self.global_step
                params, opt_states, train_loss, state['total_examples'] = \
                    self._hdf5_chunk_epoch(model=model, hdf5=hdf5, params=state['params'],
                                           opt_states=state['opt_states'], epoch=epoch,
                                           total_examples=state['total_examples'])
                split = {'steps': self.global_step - step0}
            else:
                step0 = self.global_step
                params, opt_states, train_loss, state['total_examples'] = \
                    self._per_step_epoch(model=model, params=state['params'],
                                         opt_states=state['opt_states'], train=steps[0],
                                         total_examples=state['total_examples'])
                split = {'steps': self.global_step - step0}
            state['params'], state['opt_states'] = params, opt_states

            if self.terminate_on_nan and not np.isfinite(train_loss):
                raise FloatingPointError(f'NaN/Inf train loss at epoch {epoch}.')

            val_loss = None
            if monitor_val:
                if val_fn is not None:
                    val_loss = val_fn(params, val_data, self.seed, epoch)
                else:
                    val_losses = [steps[1](params, batch) for batch in model.val_loader]
                    val_loss = self._data_mean(val_losses)
                with annotate('collie.sync'):
                    val_loss = float(val_loss)

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
                    new_lr = scaled_lr(get_lr(new_states[i]), factor,
                                       getattr(scheduler, 'min_lr', 0.0))
                    new_states[i] = set_lr(new_states[i], new_lr)
                    if self.verbosity > 0:
                        print(f'  lr[{specs[i].name}] -> {new_lr:.2e}')
            state['opt_states'] = tuple(new_states)

            if (self.checkpoint_dir is not None
                    and epoch % self.checkpoint_every_n_epochs == 0):
                self._write_checkpoint(state['params'], state['opt_states'], schedulers, epoch)

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

    # ------------------------------------------------------------ out of core

    def _hdf5_chunk_epoch(self, *, model, hdf5, params, opt_states, epoch, total_examples):
        """One epoch of the out-of-core chunk tier
        (``collie_tpu/training/trainer.py:789-850``).  The chunk plan in
        the loader's chunk order (``default_rng((loader seed, epoch))``
        when it shuffles); a background thread reads chunk c + 1 from the
        store into pinned host memory while this thread issues chunk c's
        steps, and each chunk goes to the device with ``non_blocking``
        copies.  Returns ``(params, opt_states, mean per-step loss,
        total_examples)``; the loss is the epoch's one host read."""
        loader = model.train_loader
        steps_real, n_used = hdf5_epoch_extent(loader)
        plan = hdf5_chunk_plan(steps_real, hdf5['chunk_steps'])
        if getattr(loader, 'shuffle', False):
            order_rng = np.random.default_rng((loader.seed, epoch))
            plan = [plan[i] for i in order_rng.permutation(len(plan))]
        device = model.device

        def read(start_step, steps):
            return read_hdf5_chunk(loader, start_step, steps, n_used, device)

        make, fns = hdf5['make'], hdf5['fns']
        loss_sums = []
        with ThreadPoolExecutor(max_workers=1) as reader, flight_guard():
            pending = reader.submit(read, *plan[0])
            for ci, (_, steps) in enumerate(plan):
                host = pending.result()
                if ci + 1 < len(plan):
                    pending = reader.submit(read, *plan[ci + 1])
                users, items, mask = hdf5_chunk_to_device(host, device)
                fn = fns.get(steps)
                if fn is None:
                    fn = fns[steps] = make(steps)
                params, opt_states, loss_sum = fn(params, opt_states, users, items, mask,
                                                  self.seed, epoch, ci)
                loss_sums.append(loss_sum)
        with annotate('collie.sync'):
            train_loss = float(torch.stack(loss_sums).sum() / steps_real)
        self.global_step += steps_real
        return params, opt_states, train_loss, total_examples + n_used

    # ------------------------------------------------------------- per step

    def _per_step_epoch(self, *, model, params, opt_states, train, total_examples):
        """One epoch of the per-step path: every batch of the loader's host
        iterator through ``train``, in order.  Returns ``(params,
        opt_states, mean per-step loss, total_examples)``."""
        losses = []
        for batch in model.train_loader:
            n_real = (int(np.asarray(batch['mask']).sum()) if 'mask' in batch
                      else len(batch['users']))
            params, opt_states, loss = train(params, opt_states, batch, self.global_step)
            losses.append(loss)
            total_examples += n_real
            self.global_step += 1
            if self.global_step % self.log_every_n_steps == 0 \
                    and (self.logger is not None or self.mesh is not None):
                loss = self._data_mean([loss])     # a collective: every rank takes it
                if self.logger is not None:
                    self.logger.log_metrics({'train_loss_step': float(loss)},
                                            step=self.global_step)
        with annotate('collie.sync'):
            train_loss = float(self._data_mean(losses))
        return params, opt_states, train_loss, total_examples

    def _data_mean(self, losses) -> torch.Tensor:
        """The mean of per-step losses; under a mesh each is a ``data``
        slice's share, summed over ``data`` first (one all-reduce)."""
        from collie_tpu_torch.parallel import distributed

        losses = torch.stack(losses)
        if self.mesh is not None:
            from collie_tpu_torch.parallel.mesh import DATA_AXIS
            losses = distributed.all_reduce_sum(losses, self.mesh, DATA_AXIS)
        return losses.mean()

    @staticmethod
    def _device_put_loss_metadata(model) -> None:
        """Put the loss metadata on the model's device once, before the
        epochs (``BasePipeline.loss_metadata`` keeps the tensors)."""
        model.loss_metadata()

    def _build_steps(self, model, specs, active):
        """``(train, val)`` of the per-step path: ``train(params,
        opt_states, batch, global_step) -> (params, opt_states, loss)`` and
        ``val(params, batch) -> loss`` over a numpy batch dict.  Under a mesh
        each rank takes its ``data`` slice of the batch (``shard_batch_fn``)
        and the loss is the slice's share of the batch's (``_data_mean``
        sums the shares)."""
        device = model.device
        with_dropout = not model._score_is_deterministic()
        seed = self.seed
        mesh = self.mesh
        data_index = 0
        if mesh is not None:
            from collie_tpu_torch.parallel.mesh import DATA_AXIS, axis_index
            from collie_tpu_torch.parallel.sharding import data_slice, shard_batch_fn

            shard = shard_batch_fn(mesh)
            data_index = axis_index(mesh, DATA_AXIS)

        def to_device(batch):
            """The step's tensors and its loss scale (1 without a mesh)."""
            if mesh is None:
                return {k: torch.as_tensor(np.asarray(v), device=device)
                        for k, v in batch.items()}, None
            rows = len(next(iter(batch.values())))
            mask = (np.asarray(batch['mask'], np.float32) if 'mask' in batch
                    else np.ones(rows, np.float32))
            row0, local_rows = data_slice(rows, mesh)
            mine = float(mask[row0:row0 + local_rows].sum())    # pad rows count 0
            return shard(batch), max(mine, 1.0) / max(float(mask.sum()), 1.0)

        def train(params, opt_states, batch, global_step):
            generator = None
            if with_dropout:
                generator = torch.Generator(device=device)
                generator.manual_seed(step_dropout_seed(seed, global_step, data_index))
            batch, scale = to_device(batch)
            return train_step(model, specs, active, params, opt_states, batch, generator,
                              mesh=mesh, loss_scale=scale)

        def val(params, batch):
            batch, scale = to_device(batch)
            with torch.no_grad():
                if mesh is None:
                    return model.calculate_loss(params, batch, training=False)
                return model.calculate_loss(mesh_leaves(model, mesh, params), batch,
                                            training=False) * scale

        return train, val


class CollieMinimalTrainer(CollieTrainer):
    """Alias of ``CollieTrainer`` for API parity, as in the JAX package: the
    reference's hand-rolled loop (``trainer.py:114-547``) and its Lightning
    wrapper are one engine here."""
