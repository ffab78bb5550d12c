"""The port's Feistel epoch shuffle against collie_tpu's: bit-equal given
JAX's keys (the four ints ``feistel_permutation`` draws from its key), and
a bijection of ``arange(n)`` when the port draws its own keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.ops.shuffle import feistel_permutation as jax_feistel
from collie_tpu_torch.ops.shuffle import (_mix, feistel_permutation,
                                          feistel_permutation_from_keys)


def _jax_keys(rng):
    return np.asarray(jax.random.randint(rng, (4,), 0, jnp.iinfo(jnp.int32).max,
                                         dtype=jnp.int32))


@pytest.mark.parametrize('n', [2, 3, 1000, 1024, 1025, 2 ** 17, 2 ** 17 + 1])
def test_permutation_bit_equal_to_jax(n):
    rng = jax.random.PRNGKey(n)
    expected = np.asarray(jax_feistel(rng, n))
    got = feistel_permutation_from_keys(torch.from_numpy(_jax_keys(rng).astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_mix_matches_uint32_arithmetic():
    """The int64-masked murmur mix equals uint32 arithmetic at the extremes."""
    from collie_tpu.ops.shuffle import _mix as jax_mix

    x = np.array([0, 1, 2 ** 16 - 1, 2 ** 31, 2 ** 32 - 1, 123456789], dtype=np.uint32)
    for key in (0, 1, 2 ** 31 - 2, 987654321):
        expected = np.asarray(jax_mix(jnp.asarray(x), jnp.uint32(key)))
        got = _mix(torch.from_numpy(x.astype(np.int64)), torch.tensor(key))
        np.testing.assert_array_equal(got.numpy(), expected.astype(np.int64))


@pytest.mark.parametrize('n', [2, 7, 1025, 99_991])
def test_own_keys_give_a_bijection(n):
    generator = torch.Generator().manual_seed(n)
    p = feistel_permutation(generator, n).numpy()
    assert p.shape == (n,) and p.min() == 0 and p.max() == n - 1
    assert len(np.unique(p)) == n


def test_keys_must_be_four():
    with pytest.raises(ValueError, match='4 keys'):
        feistel_permutation_from_keys(torch.arange(3), 10)


def test_cpu_keys_take_the_plain_version_and_give_int32():
    """On the CPU the permutation is the plain whole-array walk, as int32
    (the kernel's output type); the launch count stays."""
    from collie_tpu_torch.ops.shuffle import feistel_permutation_plain

    keys = torch.tensor([5, 17, 2 ** 31 - 2, 0], dtype=torch.int64)
    before = feistel_permutation_from_keys.launches
    perm = feistel_permutation_from_keys(keys, 1025)
    assert perm.dtype == torch.int32 and torch.equal(perm, feistel_permutation_plain(keys, 1025))
    assert feistel_permutation_from_keys.launches == before
    with pytest.raises(ValueError, match='2 <= n'):
        feistel_permutation_from_keys(keys, 1)


def _mf_loader(monkeypatch, slot_epoch=None):
    from collie_tpu_torch import Interactions, InteractionsDataLoader, MatrixFactorizationModel

    if slot_epoch is None:
        monkeypatch.delenv('COLLIE_TPU_SLOT_EPOCH', raising=False)
    else:
        monkeypatch.setenv('COLLIE_TPU_SLOT_EPOCH', slot_epoch)
    # 64 users of degree 64: full buckets, so the slot-domain epoch is eligible
    inter = Interactions(users=np.repeat(np.arange(64), 64), items=np.tile(np.arange(64), 64),
                         num_users=64, num_items=256, num_negative_samples=3,
                         allow_missing_ids=True, seed=0,
                         check_num_negative_samples_is_valid=False)
    loader = InteractionsDataLoader(inter, batch_size=500, shuffle=True, seed=0)
    model = MatrixFactorizationModel(train=loader, embedding_dim=4, seed=0, map_location='cpu')
    return model, loader


@pytest.mark.parametrize('setting,slots', [(None, True), ('1', True), ('0', False)])
def test_slot_epoch_knob(monkeypatch, setting, slots):
    """``COLLIE_TPU_SLOT_EPOCH=0`` sends the bucketed sampler down the
    reorder path; the epoch covers the same examples either way."""
    from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns

    model, loader = _mf_loader(monkeypatch, slot_epoch=setting)
    fn, data, S, n = build_scan_epoch_fns(model, model.optimizer_specs(), [True, True], loader,
                                          shuffle=True)
    assert fn.sampler == 'bucketed' and ('packed_slots' in data) == slots
    assert ('pos_of' in data) == (not slots)
    batches = fn.epoch_batches(0, 1)
    real = batches['mask'].reshape(-1) > 0
    pairs = (batches['users'].reshape(-1)[real] * 256 + batches['pos_items'].reshape(-1)[real])
    expected = torch.from_numpy(np.repeat(np.arange(64), 64) * 256 + np.tile(np.arange(64), 64))
    assert torch.equal(torch.sort(pairs).values, torch.sort(expected.to(pairs.dtype)).values)


@pytest.mark.parametrize('layout', ['slot', 'reorder'])
def test_shuffle_knob(monkeypatch, layout):
    """Both layouts shuffle through the Feistel walk under the keys
    ``draw_epoch`` gives: the slot-domain epoch over its grouped slots, the
    reorder epoch over the examples.  The order is the same from run to
    run, a new one each epoch, every example once."""
    from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns, draw_epoch

    model, loader = _mf_loader(monkeypatch, slot_epoch='1' if layout == 'slot' else '0')
    fn, data, *_ = build_scan_epoch_fns(model, model.optimizer_specs(), [True, True], loader,
                                        shuffle=True)
    packed = data['packed_slots' if layout == 'slot' else 'packed']
    assert ('packed_slots' in data) == (layout == 'slot')
    orders = []
    for epoch in (1, 1, 2):
        users = fn.epoch_batches(0, epoch)['users'].reshape(-1)
        keys, _ = draw_epoch(0, epoch, True, 'cpu', packed.shape[0], None, 256, True)
        perm = feistel_permutation_from_keys(keys, packed.shape[0]).long()
        assert torch.equal(users[:packed.shape[0]], packed[perm] >> 8)   # 8 item bits
        orders.append(users[:packed.shape[0]])
    first, again, later = orders
    assert torch.equal(first, again) and not torch.equal(first, later)
    assert torch.equal(torch.sort(first).values, torch.sort(later).values)
