"""Driver of the training cells: back-to-back ``CollieTrainer.fit`` calls
on one MF model, each of ``epochs_per_fit`` epochs.

Set-up makes the ratings on the card from the seed, hands them to the
package's ``Interactions`` and loader, gives the model the benchmark's own
initial tables (made on the card from the seed), and runs the first fit:
the same call the window makes, which builds the kernels on a checkout's
first run.  The window is whole fits, ending with the first that ends
after ``--seconds``; each fit continues the model for ``epochs_per_fit``
more epochs, with fresh optimizer and scheduler states.

Two fits are checked: the set-up's, from the seed's tables, and the
window's first, which follows a fit, from the tables the model holds when
the window starts (copied before its clock starts).  Of each, the state
after each of its first ``checked_epochs`` epochs is kept through the
epoch function the trainer builds (``build_scan_epoch_fns``, its
documented call and return; the wrapper passes everything else through and
stays on whatever the trainer keeps of it).  The check works those epochs
out again in plain torch (``reference/mf_epochs.py``): the batches from the
seed at the fit's epoch indices, compared element for element with the
batches the package's epoch function gives, then the training from the
fit's starting tables, compared by the epochs' losses, the optimizer's
first-epoch state and the tables' change; each number is the worse of the
two fits.
"""
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.device import sync
from portbench.reference import mf_epochs
from portbench.traffic.ratings import generate_ratings

TABLES = mf_epochs.TABLES


def _seed31(seed: int, salt: int) -> int:
    return int(np.random.SeedSequence([int(seed), salt]).generate_state(1)[0] & 0x7FFFFFFF)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.feedback = traffic['feedback']
        self.epochs = int(traffic['epochs_per_fit'])
        self.checked = int(traffic['checked_epochs'])
        self.trainer_seed = _seed31(seed, 1)
        self.fits: List[dict] = []
        self.failed = 0
        self.recorder: Optional['Recorder'] = None

    # ------------------------------------------------------------- set-up

    def make_data(self) -> None:
        data = self.config['data']
        gen = generate_ratings(data['num_users'], data['num_items'], data['num_ratings'],
                               self.seed, self.device, latent_dim=data['latent_dim'],
                               noise=data['noise'], affinity_bias=data['affinity_bias'])
        users, items, ratings = (gen[k].cpu().numpy() for k in ('users', 'items', 'ratings'))
        if self.feedback == 'implicit':
            keep = ratings >= data['min_rating_to_keep']
            users, items, ratings = users[keep], items[keep], np.ones(int(keep.sum()))
        self.raw = {'users': users, 'items': items, 'ratings': ratings.astype(np.float32)}
        self.num_users, self.num_items = data['num_users'], data['num_items']

    def initial_tables(self) -> Dict[str, torch.Tensor]:
        """The model's starting tables from the seed, in two large calls on
        the card: Normal(0, std) embeddings, zero biases (MF's own init)."""
        D = self.config['embedding_dim']
        g = torch.Generator(device=self.device)
        g.manual_seed(_seed31(self.seed, 2))
        std = self.config['init']['embedding_std']
        both = std * torch.randn(self.num_users + self.num_items, D, generator=g,
                                 device=self.device)
        return {'user_embeddings': both[:self.num_users].clone(),
                'item_embeddings': both[self.num_users:].clone(),
                'user_biases': torch.zeros(self.num_users, device=self.device),
                'item_biases': torch.zeros(self.num_items, device=self.device)}

    def setup(self) -> None:
        from collie_tpu_torch import CollieTrainer, InteractionsDataLoader, \
            MatrixFactorizationModel
        from collie_tpu_torch.data import ExplicitInteractions, Interactions

        self.make_data()
        shape = dict(num_users=self.num_users, num_items=self.num_items, allow_missing_ids=True)
        if self.feedback == 'implicit':
            inter = Interactions(users=self.raw['users'], items=self.raw['items'],
                                 ratings=self.raw['ratings'],
                                 num_negative_samples=self.traffic['num_negative_samples'],
                                 seed=self.trainer_seed, **shape)
        else:
            inter = ExplicitInteractions(users=self.raw['users'], items=self.raw['items'],
                                         ratings=self.raw['ratings'], **shape)
        loader = InteractionsDataLoader(interactions=inter, batch_size=self.config['batch_size'],
                                        shuffle=True, seed=self.trainer_seed)
        y_range = self.traffic.get('y_range')
        self.model = MatrixFactorizationModel(
            train=loader, embedding_dim=self.config['embedding_dim'], lr=self.traffic['lr'],
            bias_lr=self.config['bias_lr'], loss=self.traffic['loss'],
            y_range=tuple(y_range) if y_range else None, seed=self.trainer_seed,
            map_location=str(self.device))
        init = self.initial_tables()
        self.model.load_params(init)
        self.trainer = CollieTrainer(self.model, max_epochs=self.epochs, seed=self.trainer_seed,
                                     verbosity=0, enable_model_summary=False, logger=False)
        self.recorder = Recorder(self.checked)
        self.recorder.install()
        self.recorder.arm('setup', 1, init)
        self.trainer.fit(self.model)
        sync(self.device)

    # ------------------------------------------------------------- window

    def window(self, seconds: float, traced: bool = False) -> None:
        self.recorder.arm('window', self.model.hparams['num_epochs_completed'] + 1,
                          self.model.params)
        t0 = time.perf_counter()
        while True:
            self.trainer.max_epochs += self.epochs
            start = time.perf_counter()
            with torch.profiler.record_function('portbench.fit') if traced else nullcontext():
                self.trainer.fit(self.model)
                sync(self.device)
            end = time.perf_counter()
            self.fits.append({'start': start, 'end': end, 'log': list(self.trainer.epoch_log)})
            if end - t0 >= seconds:
                return

    @property
    def attempted(self) -> int:
        return len(self.fits)

    def end_to_end(self) -> Dict[str, float]:
        examples = sum(len(f['log']) for f in self.fits) * len(self.raw['users'])
        window = self.fits[-1]['end'] - self.fits[0]['start']
        return {'train_examples_per_s': examples / window}

    def layer_inputs(self) -> dict:
        B = self.config['batch_size']
        return {'fits': self.fits,
                'window_s': self.fits[-1]['end'] - self.fits[0]['start'],
                'shape': {'feedback': self.feedback, 'num_users': self.num_users,
                          'num_items': self.num_items, 'dim': self.config['embedding_dim'],
                          'batch': B, 'steps': self.recorder.steps,
                          'negatives': self.traffic.get('num_negative_samples', 0),
                          'epoch_kernel': ('mf_epoch_kernel' if self.feedback == 'implicit'
                                           else 'mf_explicit_epoch_kernel')}}

    def notes(self) -> List[str]:
        return [f'checked fits {[f["name"] for f in self.recorder.fits]}: '
                f'{self.recorder.route}, {self.recorder.steps} steps an epoch, '
                f'{len(self.raw["users"])} examples']

    def free_program(self) -> None:
        self.recorder.remove()
        self.model = self.trainer = None
        torch.cuda.empty_cache()

    # -------------------------------------------------------------- check

    def reference_data(self):
        if self.feedback == 'implicit':
            return mf_epochs.ImplicitData(self.raw['users'], self.raw['items'], self.num_users,
                                          self.num_items, self.device)
        return mf_epochs.ExplicitData(self.raw['users'], self.raw['items'], self.raw['ratings'],
                                      self.num_users, self.num_items, self.device)

    def reference_batches(self, data, epoch: int) -> Dict[str, torch.Tensor]:
        B = self.config['batch_size']
        if self.feedback == 'implicit':
            return data.epoch(self.trainer_seed, epoch, B, self.traffic['num_negative_samples'])
        return data.epoch(self.trainer_seed, epoch, B)

    def batch_mismatch(self, ref: Dict[str, torch.Tensor], prog: Dict[str, torch.Tensor]) -> int:
        """Elements of an epoch's batches that differ: the mask everywhere,
        the ids (and ratings) of every unmasked row."""
        if set(ref) != set(prog) or any(ref[k].shape != prog[k].shape for k in ref):
            return int(sum(v.numel() for v in ref.values()))
        live = ref['mask'] > 0
        wrong = int((ref['mask'] != prog['mask'].to(ref['mask'].dtype)).sum())
        for k in ref:
            if k == 'mask':
                continue
            differ = ref[k] != prog[k].to(ref[k].dtype)
            if differ.dim() == 3:
                differ = differ.any(-1)
            wrong += int((differ & live).sum())
        return wrong

    def train_reference(self, init: Dict[str, torch.Tensor],
                        batches: List[Dict[str, torch.Tensor]], **kwargs) -> dict:
        y_range = self.traffic.get('y_range')
        return mf_epochs.train_epochs(init, batches, feedback=self.feedback,
                                      lr=self.traffic['lr'], lr_bias=self.config['bias_lr'],
                                      y_range=tuple(y_range) if y_range else None, **kwargs)

    def numbers(self, init: Dict[str, torch.Tensor], ref: dict, prog: dict) -> Dict[str, float]:
        """The compared numbers of a record ``prog`` (``loss``, ``params``
        per epoch, ``moments`` after the first) against the reference's,
        both from the tables ``init``."""
        lr_b = self.config['bias_lr']
        ref_first = mf_epochs.first_state(ref, lr_b, init)
        prog_first = mf_epochs.first_state(prog, lr_b, init)
        last = len(ref['params']) - 1
        ref_delta = {k: ref['params'][last][k] - init[k] for k in init}
        prog_delta = {k: prog['params'][last][k].float() - init[k] for k in init}
        return {
            'loss_gap': max(abs(p - r) / abs(r) for p, r in zip(prog['loss'], ref['loss'])),
            'grad_gap': max(mf_epochs.leaf_gaps(prog_first, ref_first, ref_first).values()),
            'delta_gap': max(mf_epochs.leaf_gaps(prog_delta, ref_delta, ref_first).values()),
        }

    def check(self, controls: bool = False) -> Dict[str, float]:
        """The compared numbers, each the worse of the two checked fits;
        with ``controls`` also those of the control (the reference in
        bfloat16) and of a planted fault (half of every batch left out),
        each in the program's place."""
        data = self.reference_data()
        epoch_fn = self.recorder.epoch_fn
        out: Dict[str, float] = {'batch_mismatch': 0.0}
        if len(self.recorder.fits) != 2:
            raise RuntimeError(f'{len(self.recorder.fits)} fits recorded, 2 are checked')
        for fit in self.recorder.fits:
            epochs = range(fit['start_epoch'], fit['start_epoch'] + self.checked)
            batches = []
            for epoch in epochs:
                ref = self.reference_batches(data, epoch)
                out['batch_mismatch'] += self.batch_mismatch(
                    ref, epoch_fn.epoch_batches(self.trainer_seed, epoch))
                batches.append(ref)
            init = {k: v.to(self.device) for k, v in fit['init'].items()}
            reference = self.train_reference(init, batches)
            found = self.numbers(init, reference, fit['record'])
            if controls:
                for name, kwargs in (('control', {'dtype': torch.bfloat16}),
                                     ('fault_half_batch', {'drop_half': True})):
                    record = self.train_reference(init, batches, **kwargs)
                    found.update({f'{name}.{k}': v
                                  for k, v in self.numbers(init, reference, record).items()})
            for k, v in found.items():
                out[k] = max(out.get(k, 0.0), v)
            del batches, reference
            torch.cuda.empty_cache()
        self.recorder.epoch_fn = None
        return out


class Recorder:
    """Keeps, for an armed fit, the state after each of its first
    ``checked`` epochs.  It wraps ``build_scan_epoch_fns`` in the trainer's
    module once, before the first fit, so an epoch function the trainer
    keeps from fit to fit stays wrapped; while no fit is armed the wrapper
    only passes the call through."""

    def __init__(self, checked: int):
        self.checked = checked
        self.fits: List[dict] = []
        self.armed: Optional[dict] = None
        self.epoch_fn = None
        self.route = self.steps = None
        self.module = self.real = None

    def install(self) -> None:
        import collie_tpu_torch.training.trainer as trainer_module
        self.module, self.real = trainer_module, trainer_module.build_scan_epoch_fns
        trainer_module.build_scan_epoch_fns = self.build

    def remove(self) -> None:
        if self.module is not None:
            self.module.build_scan_epoch_fns = self.real
            self.module = None

    def arm(self, name: str, start_epoch: int, init: Dict[str, torch.Tensor]) -> None:
        """The next fit starts at ``start_epoch`` from the tables ``init``,
        copied now to the host."""
        self.armed = {'name': name, 'start_epoch': start_epoch, 'epochs': [],
                      'init': {k: v.detach().float().cpu() for k, v in init.items()}}

    def build(self, *args, **kwargs):
        fn, data, steps, examples = self.real(*args, **kwargs)
        if not kwargs.get('training', True):
            return fn, data, steps, examples
        self.steps = steps
        return _Recording(fn, self), data, steps, examples

    def keep(self, fn, out) -> None:
        fit = self.armed
        if fit is None:
            return
        params, states, loss = out
        moments = {}
        for state in states:
            mu = getattr(state, 'mu', None)
            if isinstance(mu, dict) and set(TABLES) <= set(mu):
                moments = {k: mu[k].clone() for k in TABLES}
        fit['epochs'].append({'params': {k: v.clone() for k, v in params.items()},
                              'moments': moments, 'loss': loss.clone()})
        if len(fit['epochs']) == self.checked:
            kept = fit.pop('epochs')
            fit['record'] = {'loss': [float(e['loss']) for e in kept],
                             'params': [e['params'] for e in kept],
                             'moments': kept[0]['moments']}
            self.fits.append(fit)
            self.epoch_fn = fn
            self.route = f'fused epoch kernel {fn.fused}, sampler {fn.sampler}'
            self.armed = None


class _Recording:
    """An epoch function that reports each call's result to the recorder."""

    def __init__(self, fn, recorder: Recorder):
        self.fn, self.recorder = fn, recorder

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.recorder.keep(self.fn, out)
        return out
