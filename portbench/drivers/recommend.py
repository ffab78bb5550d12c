"""Driver of the serving cells: ``retrieval.recommend`` in a closed loop of
one caller, each request sent when the previous answer is back.

The window is whole cycles of the request sizes (``traffic/requests.py``),
ending with the first cycle that ends after ``--seconds``, so every seed
sends the same work.  Set-up makes the log (``traffic/popularity.py``),
hands it to the
package's ``Interactions`` as the model's train loader (the seen set),
gives the model the benchmark's own weights, made on the card from the
seed, and sends one request of each size the traffic uses.  Each request's
time is the host clock around the call, which ends in the copy of its
answer to the host.  After the window a seeded sample of the finished
requests, the largest among them, is judged against the float64
reference (``reference/topk.py``).
"""
import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np
import torch

from portbench.device import sync
from portbench.reference import topk
from portbench.traffic.popularity import generate_interactions
from portbench.traffic.requests import Requests


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.k = int(traffic['k'])
        self.filter_seen = bool(traffic['filter_seen'])
        sizes = traffic['users_per_request']
        self.requests = Requests(config['num_users'], sizes['min'], sizes['max'],
                                 sizes['ladder'], seed)
        self.log: List[dict] = []
        self.answers: List[tuple] = []
        self.failed = 0

    def weights(self) -> Dict[str, torch.Tensor]:
        """Normal(0, std) tables and biases, in one call each on the card."""
        U, I, D = self.config['num_users'], self.config['num_items'], self.config['embedding_dim']
        init = self.config['init']
        g = torch.Generator(device=self.device)
        g.manual_seed(int(np.random.SeedSequence([self.seed, 2]).generate_state(1)[0]))
        tables = init['embedding_std'] * torch.randn(U + I, D, generator=g, device=self.device)
        biases = init['bias_std'] * torch.randn(U + I, generator=g, device=self.device)
        return {'user_embeddings': tables[:U].clone(), 'item_embeddings': tables[U:].clone(),
                'user_biases': biases[:U].clone(), 'item_biases': biases[U:].clone()}

    def setup(self) -> None:
        from collie_tpu_torch import MatrixFactorizationModel
        from collie_tpu_torch.data import Interactions
        from collie_tpu_torch.retrieval import recommend
        from collie_tpu_torch.ops.kernels.retrieval_kernel import mf_topk_retrieve

        self.recommend, self.kernel = recommend, mf_topk_retrieve
        cfg = self.config
        self.raw = generate_interactions(cfg['num_users'], cfg['num_items'],
                                         cfg['num_interactions'], self.seed,
                                         cfg['popularity_power'])
        inter = Interactions(users=self.raw['users'], items=self.raw['items'],
                             num_users=cfg['num_users'], num_items=cfg['num_items'],
                             allow_missing_ids=True, seed=self.seed % (2 ** 31))
        self.model = MatrixFactorizationModel(train=inter, embedding_dim=cfg['embedding_dim'],
                                              seed=self.seed % (2 ** 31),
                                              map_location=str(self.device))
        weights = self.weights()
        self.weights_host = {k: v.cpu() for k, v in weights.items()}
        self.model.load_params(weights)
        del weights
        warm = np.random.default_rng([self.seed, 3])
        for size in self.requests.sizes:
            self.recommend(self.model, warm.choice(cfg['num_users'], size, replace=False),
                           k=self.k, filter_seen=self.filter_seen)
        sync(self.device)

    def window(self, seconds: float, traced: bool = False) -> None:
        t0 = time.perf_counter()
        for users, cycle_done in self.requests:
            launches = self.kernel.launches
            start = time.perf_counter()
            try:
                with (torch.profiler.record_function('portbench.request') if traced
                      else nullcontext()):
                    ids, scores = self.recommend(self.model, users, k=self.k,
                                                 filter_seen=self.filter_seen)
            except Exception:                      # counted, and the run is not correct
                import traceback
                traceback.print_exc()
                self.failed += 1
                ids = scores = None
            end = time.perf_counter()
            self.log.append({'start': start, 'end': end, 'users': len(users),
                             'launches': self.kernel.launches - launches})
            self.answers.append((users, ids, scores))
            if cycle_done and end - t0 >= seconds:
                return

    @property
    def attempted(self) -> int:
        return len(self.log)

    def end_to_end(self) -> Dict[str, float]:
        latency = np.asarray([r['end'] - r['start'] for r in self.log]) * 1e3
        window = self.log[-1]['end'] - self.log[0]['start']
        return {'recommend_p95_ms': float(np.percentile(latency, 95)),
                'recommend_users_per_s': sum(r['users'] for r in self.log) / window}

    def layer_inputs(self) -> dict:
        return {'requests': self.log,
                'window_s': self.log[-1]['end'] - self.log[0]['start'],
                'shape': {'num_items': self.config['num_items'],
                          'dim': self.config['embedding_dim'], 'k': self.k}}

    def notes(self) -> List[str]:
        latency = np.asarray([r['end'] - r['start'] for r in self.log]) * 1e3
        kernel = sum(r['launches'] > 0 for r in self.log)
        p50, p95 = (float(np.percentile(latency, q)) for q in (50, 95))
        return [f'{len(self.log)} requests, {sum(r["users"] for r in self.log)} users, '
                f'{kernel} through the top-k kernel; latency ms p50 {p50!r} p95 {p95!r} '
                f'max {float(latency.max())!r}']

    def free_program(self) -> None:
        self.model = None
        torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """A seeded sample of the finished requests, the largest among them."""
        done = [i for i, a in enumerate(self.answers) if a[1] is not None]
        count = min(int(self.traffic['checked_requests']), len(done))
        rng = np.random.default_rng([self.seed, 5])
        largest = max(done, key=lambda i: len(self.answers[i][0]))
        rest = [i for i in done if i != largest]
        picked = rng.choice(rest, count - 1, replace=False).tolist() if count > 1 else []
        return sorted([largest] + picked)

    def check(self, controls: bool = False) -> Dict[str, float]:
        cfg = self.config
        seen = (topk.SeenSets(self.raw['users'], self.raw['items'], cfg['num_users'],
                              cfg['num_items']) if self.filter_seen else None)
        tables = topk.Tables(self.weights_host, self.device)
        picked = [self.answers[i] for i in self.sample()]
        out = topk.judge(picked, tables, seen)
        if controls:
            control = topk.lower_precision_answers([a[0] for a in picked], self.weights_host,
                                                   seen, self.k, self.device)
            out.update({f'control.{k}': v for k, v in topk.judge(control, tables, seen).items()})
            altered = [(u, ids.copy(), s) for u, ids, s in picked]
            for _, ids, _ in altered:
                ids[0, 0] = ids[0, -1]              # an answer altered where it is produced
            out.update({f'fault_altered.{k}': v
                        for k, v in topk.judge(altered, tables, seen).items()})
        return out
