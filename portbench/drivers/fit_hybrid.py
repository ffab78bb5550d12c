"""Driver of the staged hybrid cell: back-to-back staged jobs on one
collie ``HybridModel`` with item metadata, through ``CollieTrainer.fit``.

A job is what collie's hybrid tutorial runs: ``set_stage`` to the first
stage, then one ``fit`` of ``epochs_per_fit`` epochs in each stage in
order, ``advance_stage`` between the fits and ``trainer.max_epochs``
raised for each.  Each fit builds its own epoch tables and fresh optimizer
states for the stage's optimizers.  Set-up makes the ratings
(``traffic/ratings.py``) and the item metadata
(``traffic/item_metadata.py``) on the card from the seed, builds the
model with its own initializer from the seed, and runs one whole job.  The
window is whole jobs, ending with the first that ends after
``--seconds``; each of its stage fits is a ``portbench.fit`` span in a
traced run, which also collects the program's counters
(``training/profiler.counting``, where the program has it).

Two jobs are checked, the set-up's and the window's first, each stage fit
of them as the NeuMF driver checks a fit (``fit_neumf``): the state before
and after the first and the last step of its epoch is held through the
trainer's ``scan_engine.train_step``, the held steps' rows and the
epoch's batches are compared with the reconstruction (``batch_mismatch``),
and the reference (``reference/hybrid_epochs.py``) takes each held step
again from the program's state in that stage (``step_loss_gap``,
``step_grad_err``, ``step_delta_err``).  Besides, ``frozen_changed``
counts the leaves a stage leaves untrained (by the reference's stage
masks) that differ bit for bit after the stage's fit.
"""
import time
from contextlib import nullcontext
from typing import Dict, List

import torch

from portbench.device import sync
from portbench.drivers import fit_neumf
from portbench.drivers.fit import _seed31
from portbench.reference import hybrid_epochs
from portbench.traffic.item_metadata import item_metadata, planted_item_factors

#: the configuration's learning rates, by the reference's names
RATES = ('lr', 'bias_lr', 'metadata_only_stage_lr', 'all_stage_lr')
#: the model's constructor arguments the configuration gives
MODEL_ARGS = ('embedding_dim', 'item_metadata_layers_dims', 'user_metadata_layers_dims',
              'combined_layers_dims', 'dropout_p', 'loss', 'optimizer', 'bias_optimizer',
              'metadata_only_stage_optimizer', 'all_stage_optimizer') + RATES


class Cell(fit_neumf.Cell):
    #: the NeuMF cell's controls and fault, and a stage leak: the reference
    #: also trains the frozen tables in ``metadata_only``
    CONTROLS = fit_neumf.Cell.CONTROLS + (('fault_stage_leak', {'leak': True}),)

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(config, traffic, seed, device)
        self.stages = list(config['stages'])
        self.rates = {k: config[k] for k in RATES}
        self.jobs: List[dict] = []
        self.counts: Dict[str, int] = {}

    def setup(self) -> None:
        from collie_tpu_torch import CollieTrainer, HybridModel, InteractionsDataLoader
        from collie_tpu_torch.data import Interactions

        self.make_data()
        data = self.config['data']
        factors = planted_item_factors(data['num_users'], data['num_items'], self.seed,
                                       self.device, data['latent_dim'])
        g = torch.Generator(device=self.device)
        g.manual_seed(_seed31(self.seed, 3))
        self.metadata = item_metadata(torch.as_tensor(self.raw['items']), factors,
                                      self.config['item_metadata'], g)
        del factors
        inter = Interactions(users=self.raw['users'], items=self.raw['items'],
                             ratings=self.raw['ratings'],
                             num_negative_samples=self.traffic['num_negative_samples'],
                             seed=self.trainer_seed, num_users=self.num_users,
                             num_items=self.num_items, allow_missing_ids=True)
        loader = InteractionsDataLoader(interactions=inter, batch_size=self.config['batch_size'],
                                        shuffle=True, seed=self.trainer_seed)
        self.model = HybridModel(train=loader, item_metadata=self.metadata,
                                 seed=self.trainer_seed, map_location=str(self.device),
                                 **{k: self.config[k] for k in MODEL_ARGS})
        if self.model.hparams['stage_list'] != self.stages:
            raise RuntimeError(f'the model\'s stages {self.model.hparams["stage_list"]} are '
                               f'not the configuration\'s {self.stages}')
        self.selection = self.model.selection_route(self.traffic['num_negative_samples'])
        self.trainer = CollieTrainer(self.model, max_epochs=0, seed=self.trainer_seed,
                                     verbosity=0, enable_model_summary=False, logger=False)
        self.recorder = Recorder(self.checked, len(self.stages))
        self.recorder.install()
        self.recorder.arm('setup', 1, {})
        self.run_job()

    def run_job(self, traced: bool = False) -> dict:
        """One staged job; a checked job keeps each stage fit's leaves
        before and after it (copies on the card)."""
        span = torch.profiler.record_function if traced else (lambda name: nullcontext())
        job = {'start': time.perf_counter(), 'fits': []}
        self.model.set_stage(self.stages[0])
        for n, stage in enumerate(self.stages):
            if n:
                self.model.advance_stage()
            checked = self.recorder.armed is not None
            before = _copy(self.model.params) if checked else None
            self.trainer.max_epochs += self.epochs
            start = time.perf_counter()
            with span('portbench.fit'):
                self.trainer.fit(self.model)
                sync(self.device)
            end = time.perf_counter()
            if checked:
                self.recorder.last['leaves'] = (before, _copy(self.model.params))
            job['fits'].append({'start': start, 'end': end, 'stage': stage,
                                'log': list(self.trainer.epoch_log)})
        job['end'] = time.perf_counter()
        return job

    def window(self, seconds: float, traced: bool = False) -> None:
        from collie_tpu_torch.training import profiler

        counting = getattr(profiler, 'counting', None) if traced else None
        self.recorder.arm('window', 0, {})
        t0 = time.perf_counter()
        with (counting() if counting is not None else nullcontext({})) as counts:
            while True:
                job = self.run_job(traced)
                self.jobs.append(job)
                self.fits += job['fits']
                if job['end'] - t0 >= seconds:
                    break
        self.counts = dict(counts)

    @property
    def attempted(self) -> int:
        return len(self.jobs)

    def end_to_end(self) -> Dict[str, float]:
        examples = sum(len(f['log']) for f in self.fits) * len(self.raw['users'])
        return {'train_examples_per_s': examples / (self.jobs[-1]['end']
                                                    - self.jobs[0]['start'])}

    def layer_inputs(self) -> dict:
        return {'fits': self.fits, 'counts': self.counts,
                'window_s': self.jobs[-1]['end'] - self.jobs[0]['start'],
                'shape': {'num_users': self.num_users, 'num_items': self.num_items,
                          'dim': self.config['embedding_dim'],
                          'metadata_cols': int(self.metadata.shape[1]),
                          'combined_dims': list(self.config['combined_layers_dims']),
                          'batch': self.config['batch_size'], 'steps': self.recorder.steps,
                          'negatives': self.traffic['num_negative_samples'],
                          'examples': len(self.raw['users'])}}

    def notes(self) -> List[str]:
        held = [[h['step'] for h in f['held']] for f in self.recorder.jobs[0]['fits']] \
            if self.recorder.jobs else []
        return [f'checked jobs {[j["name"] for j in self.recorder.jobs]}: '
                f'{self.recorder.route}, selection {self.selection}, '
                f'{self.recorder.steps} steps an epoch, held steps {held}, '
                f'{len(self.raw["users"])} examples, {len(self.jobs)} jobs in the window, '
                f'metadata {tuple(self.metadata.shape)}']

    def reference_step(self, held: dict, rows: Dict[str, torch.Tensor], stage: str,
                       **kwargs) -> dict:
        """The reference's step of ``stage`` from the state ``held['before']``
        on one step's ``rows`` of the reconstructed epoch."""
        before = held['before']
        state = {'params': before['params'], 'mu': before['mu'], 'nu': before['nu'],
                 't': int(before['t']) if before['t'] is not None else 0}
        with fit_neumf._cublas_workspace():
            return hybrid_epochs.step(state, rows, stage=stage, metadata=self.metadata,
                                      rates=self.rates, **kwargs)

    def check(self, controls: bool = False) -> Dict[str, float]:
        """The compared numbers, each the worst over the held steps of every
        stage fit of the two checked jobs (``frozen_changed`` their sum);
        with ``controls`` also those of each of ``CONTROLS`` in the
        program's place, as ``<control>.<number>``."""
        data = self.reference_data()
        epoch_fn = self.recorder.epoch_fn
        out: Dict[str, float] = {'batch_mismatch': 0.0, 'frozen_changed': 0.0}
        if len(self.recorder.jobs) != 2:
            raise RuntimeError(f'{len(self.recorder.jobs)} jobs recorded, 2 are checked')
        steps = self.recorder.steps
        for job in self.recorder.jobs:
            if [f['stage'] for f in job['fits']] != self.stages:
                raise RuntimeError(f'job {job["name"]} ran the stages '
                                   f'{[f["stage"] for f in job["fits"]]}')
            for fit_record in job['fits']:
                stage, (before, after) = fit_record['stage'], fit_record['leaves']
                adam, sgd = hybrid_epochs.trained_leaves(stage, before)
                out['frozen_changed'] += sum(not torch.equal(before[k], after[k])
                                             for k in before if k not in adam + sgd)
                batches = self.reference_batches(data, fit_record['epoch'])
                out['batch_mismatch'] += self.batch_mismatch(
                    batches, epoch_fn.epoch_batches(self.trainer_seed, fit_record['epoch']))
                rows = {}
                for held in fit_record['held']:
                    if not 1 <= held['step'] <= steps:
                        raise RuntimeError(f'held step {held["step"]} lies outside the epoch')
                    row = {k: v[held['step'] - 1] for k, v in batches.items()}
                    out['batch_mismatch'] += self.batch_mismatch(
                        {k: v[None] for k, v in row.items()},
                        {k: v[None] for k, v in held['batch'].items()})
                    rows[held['step']] = {k: v.clone() for k, v in row.items()}
                del batches
                if not fit_record['held']:
                    raise RuntimeError('no step of the checked fit was held')
                for held in fit_record['held']:
                    params = held['before']['params']
                    ref = self.reference_step(held, rows[held['step']], stage)
                    got = {**held['after'], 'loss': float(held['after']['loss'])}
                    found = hybrid_epochs.step_numbers(params, ref, got)
                    if controls:
                        for name, kwargs in self.CONTROLS:
                            got = self.reference_step(held, rows[held['step']], stage, **kwargs)
                            found.update({f'{name}.{k}': v for k, v in
                                          hybrid_epochs.step_numbers(params, ref, got).items()})
                    for k, v in found.items():
                        out[k] = max(out.get(k, 0.0), v)
        self.recorder.epoch_fn = None
        return out


def _copy(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


class Recorder(fit_neumf.Recorder):
    """The NeuMF driver's recorder, by stage fit: an armed job's next
    ``num_stages`` fits are recorded, each from the epoch function the
    trainer builds for it (its stage and first epoch) to its first
    ``checked`` epochs; the state held about a step is the stage's active
    optimizers' (``train_step``'s ``active``)."""

    def __init__(self, checked: int, num_stages: int):
        super().__init__(checked)
        self.num_stages = num_stages
        self.jobs: List[dict] = []
        self.last = None

    def arm(self, name: str, start_epoch: int, init: Dict[str, torch.Tensor]) -> None:
        """The next ``num_stages`` fits are job ``name``'s; each fit's epoch
        and state are taken as it starts."""
        self.armed = {'name': name, 'fits': []}

    def build(self, model, *args, **kwargs):
        out = super().build(model, *args, **kwargs)
        if self.armed is not None and kwargs.get('training', True):
            self.last = {'stage': model.current_stage, 'held': [], 'epochs': 0,
                         'epoch': model.hparams.get('num_epochs_completed', 0) + 1}
            self.armed['fits'].append(self.last)
            self.step_no = 0
        return out

    def train_step(self, model, specs, active, params, opt_states, batch, generator=None,
                   fused_tables=False, mesh=None, loss_scale=None):
        fit_record = self.last if self.armed is not None else None
        if fit_record is not None:
            self.step_no += 1
        if fit_record is None or self.step_no not in self.held_steps():
            return self.real_step(model, specs, active, params, opt_states, batch, generator,
                                  fused_tables, mesh, loss_scale)
        live = [s for s, on in zip(opt_states, active) if on]
        before = {'params': fit_neumf._named(model, params, fused_tables),
                  **fit_neumf._moments(live)}
        out = self.real_step(model, specs, active, params, opt_states, batch, generator,
                             fused_tables, mesh, loss_scale)
        after = {'params': fit_neumf._named(model, out[0], fused_tables),
                 **fit_neumf._moments([s for s, on in zip(out[1], active) if on]),
                 'loss': out[2].clone()}
        fit_record['held'].append({'step': self.step_no, 'before': before, 'after': after,
                                   'batch': {k: v.clone() for k, v in batch.items()}})
        return out

    def keep(self, fn, out) -> None:
        if self.armed is None or self.last is None:
            return
        self.last['epochs'] += 1
        if self.last['epochs'] == self.checked and len(self.armed['fits']) == self.num_stages:
            self.jobs.append(self.armed)
            self.epoch_fn = fn
            self.route = (f'fused {fn.fused}, fused_tables {fn.fused_tables}, '
                          f'sampler {fn.sampler}')
            self.armed = None
