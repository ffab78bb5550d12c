"""The yardstick's parts at tiny sizes: seeded traffic, the counts, the
plain references against brute-force numpy, and the import rules."""
import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.metrics import _counts
from portbench.reference import mf_epochs, topk
from portbench.tests.conftest import REPO
from portbench.tracing import TraceSummary
from portbench.traffic.popularity import generate_interactions
from portbench.traffic.ratings import generate_ratings
from portbench.traffic.requests import Requests, size_ladder

CPU = torch.device('cpu')
PORTBENCH = REPO / 'portbench'


# ---------------------------------------------------------------- traffic

def test_ratings_are_seeded_distinct_and_starred():
    a = generate_ratings(500, 80, 4000, 2 ** 33 + 5, CPU, affinity_bias=3.0)
    b = generate_ratings(500, 80, 4000, 2 ** 33 + 5, CPU, affinity_bias=3.0)
    c = generate_ratings(500, 80, 4000, 2 ** 33 + 6, CPU, affinity_bias=3.0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['items'], c['items'])
    keys = a['users'] * 80 + a['items']
    assert keys.unique().numel() == 4000
    assert set(a['ratings'].tolist()) <= {1, 2, 3, 4, 5}
    # every user and item appears, and the stars follow the quantile cuts
    assert a['users'].unique().numel() == 500 and a['items'].unique().numel() == 80
    share = np.bincount(a['ratings'].numpy(), minlength=6)[1:] / 4000
    assert np.allclose(share, [0.06, 0.11, 0.27, 0.34, 0.22], atol=0.01)


def test_serving_log_and_requests_are_seeded():
    a = generate_interactions(1000, 5000, 20000, 7)
    b = generate_interactions(1000, 5000, 20000, 7)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # popularity skew: the most popular tenth of items takes most of the log
    counts = np.sort(np.bincount(a['items'], minlength=5000))[::-1]
    assert counts[:500].sum() > 0.4 * 20000
    assert size_ladder(16, 1024, 16)[0] == 16 and size_ladder(16, 1024, 16)[-1] == 1024
    first = [r for _, r in zip(range(40), Requests(1000, 4, 64, 5, 2 ** 40))]
    again = [r for _, r in zip(range(40), Requests(1000, 4, 64, 5, 2 ** 40))]
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(first, again))
    assert all(len(np.unique(r)) == len(r) for r, _ in first)
    # every cycle sends each size once, and its last request says so
    assert sorted(len(r) for r, _ in first[:5]) == size_ladder(4, 64, 5)
    assert [last for _, last in first[:10]] == [False] * 4 + [True] + [False] * 4 + [True]


# ----------------------------------------------------------------- counts

def test_counts_by_hand():
    flops, nbytes = _counts.topk_request(B=2, I=3, D=4, k=1)
    assert flops == 2 * 3 * (2 * 4 + 2)
    assert nbytes == (3 * 5 + 2 * 5) * 4 + 2 * 1 * 8
    U, I, D, S, B, K = 5, 7, 4, 3, 2, 2
    flops, nbytes = _counts.implicit_epoch(U, I, D, S, B, K)
    per_step = B * (1 + K) * (2 * D + 1) + B * 8 * D + (U + I) * D * 14 + I * 2
    assert flops == S * per_step
    assert nbytes == 2 * ((U + I) * D * 3 + I) * 4 + S * B * (3 + K) * 4 + S * 4
    flops, nbytes = _counts.explicit_epoch(U, I, D, S, B)
    assert flops == S * (B * (2 * D + 2) + B * 4 * D + (U + I) * D * 14 + (U + I) * 2)
    assert nbytes == 2 * ((U + I) * D * 3 + U + I) * 4 + S * B * 16 + S * 4
    assert _counts.least_seconds(67e12, 0) == 1.0
    assert _counts.least_seconds(0, 3.35e12) == 1.0


def test_trace_reduction_by_hand():
    host = [('portbench.window', 0, 100), ('portbench.request', 10, 40),
            ('portbench.request', 50, 90), ('aten::mm', 12, 14)]
    device = [('k1', 20, 30), ('k2', 25, 35), ('k3', 60, 70), ('portbench.request', 10, 40)]
    t = TraceSummary(device, host)
    assert t.busy_s == 25e-9 and t.window_s == 100e-9
    assert list(t.busy_between(np.array([10, 50]), np.array([40, 90]))) == [15, 10]
    assert t.op_seconds('k') == (30 / 1e9, 3)
    idle = dict(t.idle_by_host())
    # gaps [0, 20] and [70, 100] lie in requests, [35, 60] between them
    assert idle == {'portbench.request': 50 / 1e9, 'portbench.window': 25 / 1e9}


# ------------------------------------------------------------- references

def _brute_topk(ue, ie, ub, ib, users, k, seen=None):
    out = []
    for u in users:
        s = ie.astype(np.float64) @ ue[u].astype(np.float64) + ib + ub[u]
        if seen is not None:
            s[list(seen.get(u, ()))] = -np.inf
        order = sorted(range(len(s)), key=lambda j: (-s[j], j))[:k]
        out.append((order, s[order]))
    return out


@pytest.mark.parametrize('filter_seen', [False, True])
def test_topk_reference_against_brute_force(filter_seen):
    rng = np.random.default_rng(3)
    U, I, D, k = 30, 200, 8, 5
    w = {'user_embeddings': torch.randn(U, D), 'item_embeddings': torch.randn(I, D),
         'user_biases': torch.randn(U), 'item_biases': torch.randn(I)}
    log_u, log_i = rng.integers(0, U, 600), rng.integers(0, I, 600)
    seen = topk.SeenSets(log_u, log_i, U, I) if filter_seen else None
    seen_sets = {}
    for u, i in zip(log_u, log_i):
        seen_sets.setdefault(int(u), set()).add(int(i))
    users = np.arange(0, U, 2)
    brute = _brute_topk(*(w[n].numpy() for n in ('user_embeddings', 'item_embeddings',
                                                 'user_biases', 'item_biases')),
                        users, k, seen_sets if filter_seen else None)
    ids = np.array([b[0] for b in brute])
    scores = np.array([b[1] for b in brute], np.float32)
    tables = topk.Tables(w, CPU)
    good = topk.judge([(users, ids, scores)], tables, seen, block=4)
    assert good['bad_ids'] == 0 and good['topk_gap'] == 0 and good['score_err'] < 1e-6
    swapped = ids.copy()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]
    assert topk.judge([(users, swapped, scores)], tables, seen)['topk_gap'] > 0
    repeated = ids.copy()
    repeated[0, 1] = repeated[0, 0]
    assert topk.judge([(users, repeated, scores)], tables, seen)['bad_ids'] >= 1
    if filter_seen:
        u0 = int(users[0])
        stale = ids.copy()
        stale[0, -1] = sorted(seen_sets[u0])[0]
        assert topk.judge([(users, stale, scores)], tables, seen)['bad_ids'] >= 1


def _numpy_feistel(keys, n):
    keys = [int(k) & 0xFFFFFFFF for k in keys]
    bits = max((n - 1).bit_length(), 2)
    lo_bits = bits // 2
    lo_mask, hi_mask = (1 << lo_bits) - 1, (1 << (bits - lo_bits)) - 1

    def mix(x, key):
        h = (x + key) & 0xFFFFFFFF
        h = (h * 0x9E3779B9) & 0xFFFFFFFF
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        return h ^ (h >> 13)

    def enc(x):
        lo, hi = x & lo_mask, (x >> lo_bits) & hi_mask
        for i in range(4):
            if i % 2 == 0:
                lo = (lo ^ mix(hi, keys[i])) & lo_mask
            else:
                hi = (hi ^ mix(lo, keys[i])) & hi_mask
        return (hi << lo_bits) | lo

    out = []
    for x in range(n):
        e = enc(x)
        while e >= n:
            e = enc(e)
        out.append(e)
    return out


def test_feistel_and_negatives_by_brute_force():
    keys = torch.tensor([12345, 2 ** 31 - 2, 7, 99999])
    assert mf_epochs.feistel(keys, 1000).tolist() == _numpy_feistel(keys.tolist(), 1000)
    rng = np.random.default_rng(5)
    U, I = 40, 30
    keys_ui = np.unique(rng.integers(0, U, 400) * I + rng.integers(0, I, 400))
    users, items = keys_ui // I, keys_ui % I
    data = mf_epochs.ImplicitData(users, items, U, I, CPU)
    u01 = torch.rand(data.slots, 4 + 2, generator=torch.Generator().manual_seed(1))
    negs = data.negatives(u01, 4).numpy()
    for slot in range(data.slots):
        if data.slot_mask[slot] == 0:
            continue
        u = int(data.slot_user[slot])
        pos = set(items[users == u].tolist())
        complement = [i for i in range(I) if i not in pos]
        m = len(complement)
        draws = [complement[min(int(np.float32(x) * np.float32(m)), m - 1)]
                 for x in u01[slot].tolist()]
        want = draws[:4]
        dups = [j for j in range(4) if want[j] in want[:j]]
        for rank, j in enumerate(dups[:2]):
            want[j] = draws[4 + rank]
        assert negs[slot].tolist() == want


def test_training_reference_against_numpy_step():
    """One implicit step and one explicit step against numpy, by hand."""
    rng = np.random.default_rng(11)
    U, I, D, B, K = 6, 9, 3, 4, 3
    init = {'user_embeddings': torch.tensor(rng.normal(size=(U, D)), dtype=torch.float64),
            'item_embeddings': torch.tensor(rng.normal(size=(I, D)), dtype=torch.float64),
            'user_biases': torch.zeros(U, dtype=torch.float64),
            'item_biases': torch.tensor(rng.normal(size=I), dtype=torch.float64)}
    u = rng.integers(0, U, B)
    p = rng.integers(0, I, B)
    n = rng.integers(0, I, (B, K))
    mask = np.array([1, 1, 1, 0], np.float64)
    batch = {'users': torch.tensor(u)[None], 'pos_items': torch.tensor(p)[None],
             'neg_items': torch.tensor(n)[None], 'mask': torch.tensor(mask)[None]}
    out = mf_epochs.train_epochs(init, [batch], feedback='implicit', lr=0.1, lr_bias=0.01,
                                 dtype=torch.float64)
    ue, ie, ib = (init[k].numpy() for k in ('user_embeddings', 'item_embeddings',
                                            'item_biases'))
    pos = (ue[u] * ie[p]).sum(1) + ib[p]
    neg = (ue[u][:, None] * ie[n]).sum(2) + ib[n]
    h = n[np.arange(B), neg.argmax(1)]
    l = np.maximum(1 - pos + neg.max(1), 0)
    assert math.isclose(out['loss'][0], ((l + l * l) * mask).sum() / mask.sum(), rel_tol=1e-6)
    dl = np.where(l > 0, (1 + 2 * l) * mask / mask.sum(), 0)
    g_ie = np.zeros_like(ie)
    np.add.at(g_ie, p, -dl[:, None] * ue[u])
    np.add.at(g_ie, h, dl[:, None] * ue[u])
    # Adam's first step moves each touched element by lr * sign(g)
    step = 0.1 * g_ie / (np.abs(g_ie) + 1e-8)
    got = out['params'][0]['item_embeddings'].numpy()
    assert np.allclose(got, ie - step, atol=1e-6)
    g_ib = np.zeros(I)
    np.add.at(g_ib, p, -dl)
    np.add.at(g_ib, h, dl)
    assert np.allclose(out['params'][0]['item_biases'].numpy(), ib - 0.01 * g_ib)

    r = rng.integers(1, 6, B).astype(np.float64)
    batch = {'users': torch.tensor(u)[None], 'items': torch.tensor(p)[None],
             'ratings': torch.tensor(r)[None], 'mask': torch.tensor(mask)[None]}
    out = mf_epochs.train_epochs(init, [batch], feedback='explicit', lr=0.01, lr_bias=0.01,
                                 dtype=torch.float64, y_range=(1, 5))
    x = (ue[u] * ie[p]).sum(1) + ib[p]
    pred = 1 / (1 + np.exp(-x)) * 4 + 1
    assert math.isclose(out['loss'][0], ((pred - r) ** 2 * mask).sum() / mask.sum(),
                        rel_tol=1e-6)


def test_leaf_gaps_leave_out_unmoved_leaves():
    ref = {'a': torch.ones(4), 'b': torch.full((4,), 2.0), 'c': torch.zeros(4)}
    prog = {'a': torch.ones(4) * 1.1, 'b': torch.full((4,), 2.0), 'c': torch.ones(4)}
    gaps = mf_epochs.leaf_gaps(prog, ref, ref)
    assert set(gaps) == {'a', 'b'} and math.isclose(gaps['a'], 0.1 * 2 / 3, rel_tol=1e-5)


# ---------------------------------------------------------------- imports

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in PORTBENCH.rglob('*.py'):
        tops = {name.split('.', 1)[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / 'reference').rglob('*.py'):
        tops = {name.split('.', 1)[0] for name in _imports(path)}
        assert tops <= {'typing', 'numpy', 'torch'}, (path, tops)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(['collie_tpu_torch', 'collie_tpu_torch.ops', 'jaxtyping',
                                      'numpy']) == []
    assert harness.forbidden_modules(['collie_tpu.ops', 'jax.numpy', 'flax']) \
        == ['collie_tpu', 'flax', 'jax']


@pytest.mark.cuda
def test_a_run_on_the_card_loads_no_jax(tmp_path):
    """On a card: a short run in a fresh process ends with no forbidden
    module loaded (the run itself refuses otherwise) and a result line."""
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                          'mf_msd.recommend_batch', '--seed', '5', '--seconds', '1',
                          '--trace', '0'], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1].startswith('{')
