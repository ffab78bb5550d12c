"""The bucketed sampler's tables built on the device
(``build_bucketed_complement_tables_torch``, the port's one builder, here on
the CPU) against collie_tpu's numpy builder, array by array and dtype by
dtype; the degree-based sizing ``select_sampler`` is given against
collie_tpu's ``bucketed_table_bytes``; and the training engine's epochs,
which take the device builder, against the same engine fed collie_tpu's
tables.
"""
import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix

import collie_tpu.ops.device_sampling as J
from collie_tpu_torch import InteractionsDataLoader, MatrixFactorizationModel
from collie_tpu_torch.data import Interactions
from collie_tpu_torch.ops import device_sampling as T
from collie_tpu_torch.training import scan_engine

NUM_USERS, NUM_ITEMS = 48, 700


def _skewed_pairs(rng):
    """Users 0-5 hold every item, 600, 400, 129, 128 and 127 items (buckets
    3, 3, 2, 1, 0, 0 of widths 128-1024), users 6-8 none, the rest 1-59."""
    degrees = rng.integers(1, 60, NUM_USERS)
    degrees[:9] = [NUM_ITEMS, 600, 400, 129, 128, 127, 0, 0, 0]
    rows = np.repeat(np.arange(NUM_USERS), degrees)
    cols = np.concatenate([rng.choice(NUM_ITEMS, d, replace=False) for d in degrees])
    return rows, cols


def _skewed_problem():
    """40 users x 700 items in user order (``tests/test_device_sampling.py``'s
    skewed problem): one user of degree 400, the boundary degrees 129, 128
    and 127, the rest 1-59."""
    rng = np.random.default_rng(5)
    degrees = rng.integers(1, 60, 40)
    degrees[:4] = [400, 129, 128, 127]
    rows = np.repeat(np.arange(40), degrees)
    cols = np.concatenate([rng.choice(NUM_ITEMS, d, replace=False) for d in degrees])
    return rows, cols


def _case(name):
    """``(rows, cols, example_rows or None, chunk, num_users)`` of one case."""
    if name.startswith('skewed_'):           # buckets of 128, 256 and 512
        return (*_skewed_problem(), None, int(name[len('skewed_'):]), 40)
    return (*_standard_case(name), NUM_USERS)


def _standard_case(name):
    rng = np.random.default_rng(17)
    rows, cols = _skewed_pairs(rng)
    if name == 'user_order':                 # bucket 1 under the chunk, the rest over it
        return rows, cols, None, 256
    if name == 'one_chunk':                  # every bucket under the chunk
        return rows, cols, None, 8192
    order = rng.permutation(len(rows))
    rows, cols = rows[order], cols[order]
    if name == 'shuffled':
        return rows, cols, None, 256
    if name == 'duplicates':
        again = rng.integers(0, len(rows), len(rows) // 5)
        inter = Interactions(users=np.concatenate([rows, rows[again]]),
                             items=np.concatenate([cols, cols[again]]),
                             num_users=NUM_USERS, num_items=NUM_ITEMS, allow_missing_ids=True,
                             remove_duplicate_user_item_pairs=False,
                             check_num_negative_samples_is_valid=False)
        assert inter.num_interactions > len(rows)
        return inter.mat.row, inter.mat.col, None, 256
    if name == 'subset':                     # users 0, 3, 6, ... give no example
        keep = rows % 3 != 0
        return rows, cols, rows[keep][rng.permutation(int(keep.sum()))], 256
    raise ValueError(name)


CASES = ['user_order', 'one_chunk', 'shuffled', 'duplicates', 'subset']


def _device_tables(rows, cols, example_rows, chunk, num_users=NUM_USERS):
    return T.build_bucketed_complement_tables_torch(
        torch.as_tensor(rows), torch.as_tensor(cols), num_users, NUM_ITEMS, chunk=chunk,
        example_rows=None if example_rows is None else torch.as_tensor(example_rows))


def _assert_tables_equal(got, ref):
    """``got`` (tensors) equals ``ref`` (numpy arrays), value and dtype."""
    assert len(got[0]) == len(ref[0])
    pairs = [(g, r) for gs, rs in zip(got[0], ref[0]) for g, r in zip(gs, rs)]
    pairs += list(zip(got[1:], ref[1:]))
    for g, r in pairs:
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize('name', CASES + ['skewed_256', 'skewed_8192'])
def test_device_builder_equals_jax_builder(name):
    rows, cols, example_rows, chunk, num_users = _case(name)
    mat = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(num_users, NUM_ITEMS))
    ex = rows if example_rows is None else example_rows
    ref = J.build_bucketed_complement_tables(mat, ex, chunk=chunk)
    got = _device_tables(rows, cols, example_rows, chunk, num_users)
    _assert_tables_equal(got, ref)
    widths = [int(t.shape[1]) for _, t in got[0]]
    if name == 'subset':
        assert 256 not in widths             # bucket 1 (user 3 alone) has no example
    else:
        assert widths == ([128, 256, 512] if name.startswith('skewed_')
                          else [128, 256, 512, 1024])
    if name != 'subset':
        plan = T.plan_bucketed_complement_tables(torch.as_tensor(rows), torch.as_tensor(cols),
                                                 num_users, NUM_ITEMS)
        sizes = [n for n in plan.examples_per_bucket if n]
        assert min(sizes) < chunk and (chunk == 8192 or max(sizes) > chunk)


@pytest.mark.parametrize('name', CASES)
def test_select_sampler_sizes_from_degrees(name, monkeypatch):
    rows, cols, example_rows, _, _ = _case(name)
    mat = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(NUM_USERS, NUM_ITEMS))
    plan = T.plan_bucketed_complement_tables(
        torch.as_tensor(rows), torch.as_tensor(cols), NUM_USERS, NUM_ITEMS,
        None if example_rows is None else torch.as_tensor(example_rows))
    nbytes = J.bucketed_table_bytes(mat)
    assert plan.table_bytes == nbytes
    # the budget at the tables' size takes them, a byte less does not
    for budget, expected in ((nbytes, 'bucketed'), (nbytes - 1, 'csr')):
        monkeypatch.setenv('COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB', repr(budget / 2 ** 20))
        assert scan_engine.select_sampler(plan.table_bytes) == expected


def test_device_builder_with_no_examples():
    got = T.build_bucketed_complement_tables_torch(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64), 3, 5)
    ref = J.build_bucketed_complement_tables(coo_matrix((3, 5)), np.zeros(0, np.int64))
    _assert_tables_equal(got, ref)


def _numpy_tables(users, items, num_users, num_items, plan=None):
    """The engine's tables as it built them before: collie_tpu's numpy
    builder over the COO pairs, uploaded."""
    mat = coo_matrix((np.ones(users.shape[0]), (users.numpy(), items.numpy())),
                     shape=(num_users, num_items))
    specs, counts, users_g, pos_of = J.build_bucketed_complement_tables(mat, users.numpy())
    return (tuple((torch.from_numpy(r), torch.from_numpy(t)) for r, t in specs),
            torch.from_numpy(counts), torch.from_numpy(users_g), torch.from_numpy(pos_of))


def _loader(even_buckets, drop_last):
    """Pairs in a shuffled order over 140 users, 5 of them with no item.
    ``even_buckets``: 128 users x 64 items, 3 users with 150, 180 and 182
    and one with 512 make buckets of 8,192, 512 and 512 examples, no pad
    slot, so a shuffled epoch takes the slot-domain path; otherwise (1-127
    items, 200 in place of 182) the buckets of 128 and 256 are padded past
    2% and the epoch takes the reorder path."""
    rng = np.random.default_rng(3)
    degrees = np.zeros(140, np.int64)
    degrees[:128] = 64 if even_buckets else rng.integers(1, 128, 128)
    degrees[128:132] = [150, 180, 182 if even_buckets else 200, 512]
    rows = np.repeat(np.arange(140), degrees)
    cols = np.concatenate([rng.choice(1024, d, replace=False) for d in degrees])
    order = rng.permutation(len(rows))
    inter = Interactions(users=rows[order], items=cols[order], num_users=140, num_items=1024,
                         allow_missing_ids=True, num_negative_samples=3, seed=0,
                         check_num_negative_samples_is_valid=False)
    return InteractionsDataLoader(inter, batch_size=1000, shuffle=True, drop_last=drop_last,
                                  seed=0)


def _assert_data_equal(data, ref):
    assert data.keys() == ref.keys()
    for key in data:
        got = data[key]
        want = ref[key]
        if key == 'bucket_specs':
            got = [t for pair in got for t in pair]
            want = [t for pair in want for t in pair]
        else:
            got, want = [got], [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), key


# (layout, loader's even buckets, drop_last, training)
EPOCHS = [('slot', True, False, True), ('reorder_drop_last', True, True, True),
          ('reorder_padded', False, False, True), ('validation', True, False, False)]


@pytest.mark.parametrize('layout,even,drop_last,training', EPOCHS)
def test_engine_epochs_unchanged_from_numpy_tables(layout, even, drop_last, training,
                                                   monkeypatch):
    loader = _loader(even, drop_last)
    model = MatrixFactorizationModel(train=loader, embedding_dim=4, seed=0, map_location='cpu')
    specs = model.optimizer_specs()

    def build():
        return scan_engine.build_scan_epoch_fns(model, specs, [True, True], loader,
                                                shuffle=training, training=training)

    fn, data, S, n = build()
    monkeypatch.setattr(scan_engine, 'build_bucketed_complement_tables_torch', _numpy_tables)
    ref_fn, ref_data, ref_S, ref_n = build()
    assert fn.sampler == ref_fn.sampler == 'bucketed'
    assert ('packed_slots' in data) == (layout == 'slot')
    assert ('pos_of' in data) == (layout != 'slot')
    assert (S, n) == (ref_S, ref_n)
    _assert_data_equal(data, ref_data)
    for epoch in (1, 2):
        if training:
            batches, ref_batches = fn.epoch_batches(7, epoch), ref_fn.epoch_batches(7, epoch)
            assert batches.keys() == ref_batches.keys()
            for key in batches:
                assert torch.equal(batches[key], ref_batches[key]), key
        else:
            assert torch.equal(fn(model.params, data, 7, epoch),
                               ref_fn(model.params, ref_data, 7, epoch))
