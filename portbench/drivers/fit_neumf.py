"""Driver of the NeuMF training cells: back-to-back ``CollieTrainer.fit``
calls on one ``NeuralCollaborativeFiltering`` model, each of
``epochs_per_fit`` epochs, through the trainer's generic epoch.

The MF driver's (``drivers/fit.py``) set-up, window and end-to-end metric,
with NeuMF's own parts: the model from the configuration, its starting
weights its own initializer's from the seed, and the reference
``reference/neumf_epochs.py``.  Two fits are checked, the set-up's and the
window's first, as in the MF cells, and their batches are worked out again
by ``ImplicitData`` (``mf_epochs``' layout with the pack rule;
``batch_mismatch``).

The training is checked step by step.  At lr 1e-3 from this initializer,
Adam's first steps move every element by about the rate whatever its
gradient's size, and some gradients start as rounding noise (the predict
layer's bias gets exactly none from a pairwise loss), so two float32
trajectories that round differently part within tens of steps.  So the
recorder keeps, of each checked fit, the state before and after some of its
steps (``held_steps``: the first, the first epoch's last, the last checked
epoch's last), through the trainer's ``scan_engine.train_step`` (its
documented call and return; everything passes through).  The rows the
program trained each held step on are compared with the same step's row of
the reconstructed epoch (``batch_mismatch`` again), and the reference takes
the step again from the program's own state before it, on the
reconstruction's rows; the check compares the step's loss
(``step_loss_gap``), the Adam first moments after it (``step_grad_err``)
and its change of every leaf (``step_delta_err``); an ``*_err`` compares
leaves element by element (``neumf_epochs.leaf_errors``).
"""
import contextlib
import os
from typing import Dict, List

import torch

from portbench.device import sync
from portbench.drivers import fit
from portbench.reference import mf_epochs, neumf_epochs


class Cell(fit.Cell):
    #: the reference in the program's place: two controls (TF32 matmuls and
    #: bfloat16, the precisions below the configured float32) and a fault
    CONTROLS = (('control_tf32', {'tf32': True}),
                ('control_bf16', {'dtype': torch.bfloat16}),
                ('fault_half_batch', {'drop_half': True}))

    def setup(self) -> None:
        from collie_tpu_torch import (CollieTrainer, InteractionsDataLoader,
                                      NeuralCollaborativeFiltering)
        from collie_tpu_torch.data import Interactions

        self.make_data()
        inter = Interactions(users=self.raw['users'], items=self.raw['items'],
                             ratings=self.raw['ratings'],
                             num_negative_samples=self.traffic['num_negative_samples'],
                             seed=self.trainer_seed, num_users=self.num_users,
                             num_items=self.num_items, allow_missing_ids=True)
        loader = InteractionsDataLoader(interactions=inter, batch_size=self.config['batch_size'],
                                        shuffle=True, seed=self.trainer_seed)
        self.model = NeuralCollaborativeFiltering(
            train=loader, embedding_dim=self.config['embedding_dim'],
            num_layers=self.config['num_layers'], loss=self.traffic['loss'],
            lr=self.traffic['lr'], optimizer=self.config['optimizer'], seed=self.trainer_seed,
            map_location=str(self.device))
        self.selection = self.model.selection_route(self.traffic['num_negative_samples'])
        self.trainer = CollieTrainer(self.model, max_epochs=self.epochs, seed=self.trainer_seed,
                                     verbosity=0, enable_model_summary=False, logger=False)
        self.recorder = Recorder(self.checked)
        self.recorder.install()
        self.recorder.arm('setup', 1, self.model.params)
        self.trainer.fit(self.model)
        sync(self.device)

    def layer_inputs(self) -> dict:
        return {'fits': self.fits,
                'window_s': self.fits[-1]['end'] - self.fits[0]['start'],
                'shape': {'num_users': self.num_users, 'num_items': self.num_items,
                          'dim': self.config['embedding_dim'],
                          'layers': self.config['num_layers'],
                          'batch': self.config['batch_size'], 'steps': self.recorder.steps,
                          'negatives': self.traffic['num_negative_samples']}}

    def notes(self) -> List[str]:
        held = [h['step'] for h in self.recorder.fits[0]['held']] if self.recorder.fits else []
        return [f'checked fits {[f["name"] for f in self.recorder.fits]}: '
                f'{self.recorder.route}, selection {self.selection}, '
                f'{self.recorder.steps} steps an epoch, held steps {held}, '
                f'{len(self.raw["users"])} examples']

    def reference_data(self):
        return ImplicitData(self.raw['users'], self.raw['items'], self.num_users,
                            self.num_items, self.device)

    def reference_step(self, held: dict, rows: Dict[str, torch.Tensor], **kwargs) -> dict:
        """The reference's step from the state ``held['before']`` on one
        step's ``rows`` of the reconstructed epoch."""
        before = held['before']
        state = {'params': before['params'], 'mu': before['mu'], 'nu': before['nu'],
                 't': int(before['t'])}
        with _cublas_workspace():
            return neumf_epochs.step(state, rows, lr=self.traffic['lr'],
                                     num_layers=self.config['num_layers'], **kwargs)

    @staticmethod
    def step_numbers(held: dict, ref: dict, got: dict) -> Dict[str, float]:
        """The compared numbers of a held step's result ``got`` against the
        reference's ``ref``, both from the state ``held['before']``."""
        before = held['before']['params']
        grads = ref['mu']
        ref_delta = {k: ref['params'][k] - before[k] for k in before}
        got_delta = {k: got['params'][k] - before[k] for k in before}
        return {'step_loss_gap': abs(got['loss'] - ref['loss']) / abs(ref['loss']),
                'step_grad_err': max(neumf_epochs.leaf_errors(got['mu'], grads,
                                                              grads).values()),
                'step_delta_err': max(neumf_epochs.leaf_errors(got_delta, ref_delta,
                                                               grads).values())}

    def check(self, controls: bool = False) -> Dict[str, float]:
        """The compared numbers, each the worst over the held steps of the
        two checked fits; with ``controls`` also those of each of
        ``CONTROLS`` in the program's place, as ``<control>.<number>``."""
        data = self.reference_data()
        epoch_fn = self.recorder.epoch_fn
        out: Dict[str, float] = {'batch_mismatch': 0.0}
        if len(self.recorder.fits) != 2:
            raise RuntimeError(f'{len(self.recorder.fits)} fits recorded, 2 are checked')
        steps = self.recorder.steps
        for fit_record in self.recorder.fits:
            if not fit_record['held']:
                raise RuntimeError('no step of the checked fit was held')
            rows = {}
            for n in range(self.checked):
                epoch = fit_record['start_epoch'] + n
                batches = self.reference_batches(data, epoch)
                out['batch_mismatch'] += self.batch_mismatch(
                    batches, epoch_fn.epoch_batches(self.trainer_seed, epoch))
                for held in fit_record['held']:
                    if (held['step'] - 1) // steps == n:
                        row = {k: v[(held['step'] - 1) % steps] for k, v in batches.items()}
                        out['batch_mismatch'] += self.batch_mismatch(
                            {k: v[None] for k, v in row.items()},
                            {k: v[None] for k, v in held['batch'].items()})
                        rows[held['step']] = {k: v.clone() for k, v in row.items()}
                del batches
            for held in fit_record['held']:
                if held['step'] not in rows:
                    raise RuntimeError(f'held step {held["step"]} lies outside the checked epochs')
                ref = self.reference_step(held, rows[held['step']])
                got = {**held['after'], 'loss': float(held['after']['loss'])}
                found = self.step_numbers(held, ref, got)
                if controls:
                    for name, kwargs in self.CONTROLS:
                        got = self.reference_step(held, rows[held['step']], **kwargs)
                        found.update({f'{name}.{k}': v
                                      for k, v in self.step_numbers(held, ref, got).items()})
                for k, v in found.items():
                    out[k] = max(out.get(k, 0.0), v)
        self.recorder.epoch_fn = None
        return out


class ImplicitData(mf_epochs.ImplicitData):
    """``mf_epochs.ImplicitData`` with the epoch's further rule for the slot
    layout: the epoch shuffles slots only where a (user, item) pair also
    packs into 31 bits (``user << item_bits | item``, item_bits the bits of
    the largest item id).  ML-20M's 138,493 users and 26,744 items do not,
    so its epochs shuffle the examples and each reads its negatives from
    its slot."""

    def __init__(self, users, items, num_users: int, num_items: int, device):
        super().__init__(users, items, num_users, num_items, device)
        item_bits = max((num_items - 1).bit_length(), 1)
        self.slot_epoch = self.slot_epoch and \
            ((num_users - 1) << item_bits | (num_items - 1)) < 2 ** 31


@contextlib.contextmanager
def _cublas_workspace():
    """cuBLAS's fixed workspace, which deterministic products on a card ask
    for, set for the reference alone and restored after it."""
    was = os.environ.get('CUBLAS_WORKSPACE_CONFIG')
    os.environ['CUBLAS_WORKSPACE_CONFIG'] = was or ':4096:8'
    try:
        yield
    finally:
        if was is None:
            del os.environ['CUBLAS_WORKSPACE_CONFIG']


def _named(model, params: Dict[str, torch.Tensor], fused_tables: bool):
    """The params by leaf name, copied: a fused table split into its parts
    (``model.unfuse_params``)."""
    if fused_tables:
        params = model.unfuse_params(params)
    return {k: v.detach().clone() for k, v in params.items()}


def _moments(states) -> dict:
    """Adam's count and moments, copied, over every optimizer's state."""
    out = {'t': None, 'mu': {}, 'nu': {}}
    for state in states:
        mu = getattr(state, 'mu', None)
        if isinstance(mu, dict) and mu:
            out['mu'].update({k: v.clone() for k, v in mu.items()})
            out['nu'].update({k: v.clone() for k, v in state.nu.items()})
            out['t'] = state.adam_count.clone()
    return out


class Recorder(fit.Recorder):
    """The MF driver's recorder (an armed fit's first ``checked`` epochs,
    kept through the epoch function), which also holds the state before and
    after the armed fit's ``held_steps``, through ``scan_engine.train_step``,
    and names the epoch's route: the fused kernel or the generic epoch, the
    table layout and the sampler."""

    def __init__(self, checked: int):
        super().__init__(checked)
        self.step_module = self.real_step = None
        self.step_no = 0

    def install(self) -> None:
        super().install()
        from collie_tpu_torch.training import scan_engine
        self.step_module, self.real_step = scan_engine, scan_engine.train_step
        scan_engine.train_step = self.train_step

    def remove(self) -> None:
        super().remove()
        if self.step_module is not None:
            self.step_module.train_step = self.real_step
            self.step_module = None

    def arm(self, name: str, start_epoch: int, init: Dict[str, torch.Tensor]) -> None:
        """The next fit starts at ``start_epoch``; its starting leaves need no
        copy, since each held step keeps its own."""
        self.armed = {'name': name, 'start_epoch': start_epoch, 'epochs': [], 'held': []}
        self.step_no = 0

    def held_steps(self) -> set:
        """The steps of an armed fit, counted from 1, whose states are held:
        the first, the last of its first epoch, the last of its last checked
        epoch."""
        return {1, self.steps, self.checked * self.steps}

    def train_step(self, model, specs, active, params, opt_states, batch, generator=None,
                   fused_tables=False, mesh=None, loss_scale=None):
        fit_record = self.armed
        if fit_record is not None:
            self.step_no += 1
        if fit_record is None or self.step_no not in self.held_steps():
            return self.real_step(model, specs, active, params, opt_states, batch, generator,
                                  fused_tables, mesh, loss_scale)
        before = {'params': _named(model, params, fused_tables), **_moments(opt_states)}
        out = self.real_step(model, specs, active, params, opt_states, batch, generator,
                             fused_tables, mesh, loss_scale)
        after = {'params': _named(model, out[0], fused_tables), **_moments(out[1]),
                 'loss': out[2].clone()}
        fit_record['held'].append({'step': self.step_no, 'before': before, 'after': after,
                                   'batch': {k: v.clone() for k, v in batch.items()}})
        return out

    def keep(self, fn, out) -> None:
        fit_record = self.armed
        if fit_record is None:
            return
        fit_record['epochs'].append(None)              # counted; the state is held by step
        if len(fit_record['epochs']) == self.checked:
            del fit_record['epochs']
            self.fits.append(fit_record)
            self.epoch_fn = fn
            self.route = (f'fused {fn.fused}, fused_tables {fn.fused_tables}, '
                          f'sampler {fn.sampler}')
            self.armed = None
