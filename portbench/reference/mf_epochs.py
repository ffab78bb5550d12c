"""Plain reference of the first epochs of an MF fit: the epoch's batches
worked out again from the seed, then the training, in plain torch.

Imports nothing of the package under test.  It restates the semantics that
``collie_tpu_torch`` documents for a whole-epoch fit of a
``MatrixFactorizationModel`` on an in-memory loader with ``shuffle=True``:

* **Randomness**: one ``torch.Generator`` on the card a (seed, epoch),
  seeded with ``(seed * 1_000_003 + epoch * 2 + 1) mod 2^63``; it draws four
  Feistel keys (``randint(0, 2^31 - 1, (4,))``, int64), then, for implicit
  data, the sampler's float32 uniforms ``[slots, K + 2]``.
* **Order**: the keys' 4-round Feistel bijection of ``[0, n)``, cycle-walked
  (the JAX package's ``ops/shuffle.py``).  Explicit data shuffles its
  examples; implicit data shuffles *slots* of a grouped layout: users in
  power-of-two degree buckets (128, 256, ...), each bucket's examples sorted
  by user (stable), each bucket padded to a multiple of
  ``min(8192, next_pow2(bucket examples))`` with masked slots; where that
  padding passes 2% of the examples, the examples themselves are shuffled
  and each reads its negatives from its slot.  Batches are consecutive runs
  of ``B`` permuted positions; the last batch is filled with masked repeats
  of the first.
* **Negatives**: per slot and draw ``u``, ``r = min(trunc(u * m), m - 1)``
  in float32 with ``m = num_items - degree``, and the negative is the
  ``r``-th item the user has not interacted with.  Within a row the second
  and third duplicates of an earlier negative take the two spare draws.
* **Training**: per step the hardest of the K negatives (first maximum),
  collie's composite hinge ``(sum l + sum l^2) / max(sum w, 1)`` with
  ``l = relu(1 - pos + neg)`` (implicit), or the weighted MSE of
  ``sigmoid(u.i + b_u + b_i) * (hi - lo) + lo`` (explicit); optax Adam
  (0.9, 0.999, 1e-8, ``eps`` outside the root) on both tables, updated
  densely every step, and SGD on the biases.  The plateau scheduler cannot
  cut the rate before epoch 4, so epochs 1-3 train at the initial rates.
"""
from typing import Dict, List, Optional

import numpy as np
import torch

LANE = 128
CHUNK = 8192
SPARES = 2
KEY_HIGH = 2 ** 31 - 1
MASK32 = 0xFFFFFFFF
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# ------------------------------------------------------------------ order

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _mix(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    h = (x + key) & MASK32
    h = _mul32(h, 0x9E3779B9)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def feistel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The keys' bijection of ``[0, n)``, int64."""
    keys = keys.to(torch.int64) & MASK32
    bits = max((n - 1).bit_length(), 2)
    lo_bits = bits // 2
    lo_mask, hi_mask = (1 << lo_bits) - 1, (1 << (bits - lo_bits)) - 1

    def encrypt(x):
        lo, hi = x & lo_mask, (x >> lo_bits) & hi_mask
        for i in range(4):
            if i % 2 == 0:
                lo = (lo ^ _mix(hi, keys[i])) & lo_mask
            else:
                hi = (hi ^ _mix(lo, keys[i])) & hi_mask
        return (hi << lo_bits) | lo

    e = encrypt(torch.arange(n, dtype=torch.int64, device=keys.device))
    while True:
        out = e >= n
        if not bool(out.any()):
            return e
        e = torch.where(out, encrypt(e), e)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(epoch) * 2 + 1) % (2 ** 63))
    return g


def draw_keys(g: torch.Generator) -> torch.Tensor:
    return torch.randint(0, KEY_HIGH, (4,), generator=g, device=g.device, dtype=torch.int64)


# --------------------------------------------------------------- layouts

class ImplicitData:
    """The positives of an implicit log, laid out as the epoch needs them."""

    def __init__(self, users: np.ndarray, items: np.ndarray, num_users: int, num_items: int,
                 device):
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        keys = users * num_items + items
        if len(np.unique(keys)) != len(keys):
            raise ValueError('the reference takes distinct (user, item) pairs')
        self.num_users, self.num_items, self.n = num_users, num_items, len(users)
        self.device = device
        degree = np.bincount(users, minlength=num_users)
        # CSR of each user's sorted positives, and their shifted values
        order = np.lexsort((items, users))
        cols = items[order]
        indptr = np.concatenate([[0], np.cumsum(degree)])
        rank = np.arange(len(cols)) - np.repeat(indptr[:-1], degree)
        shifted = cols - rank
        self.flat = torch.as_tensor((users[order] << 31) + shifted, device=device)
        self.indptr = torch.as_tensor(indptr, device=device)
        self.degree = torch.as_tensor(degree, device=device)
        # the grouped slot layout
        widths = [LANE]
        while widths[-1] < max(int(degree.max()), 1):
            widths.append(widths[-1] * 2)
        bucket = np.searchsorted(np.asarray(widths), degree[users])
        slot_user, slot_item, slot_mask = [], [], []
        pos_of = np.zeros(len(users), np.int64)
        offset = 0
        for b in range(len(widths)):
            ex = np.where(bucket == b)[0]
            if len(ex) == 0:
                continue
            ex = ex[np.argsort(users[ex], kind='stable')]
            pad = -len(ex) % min(CHUNK, 1 << (len(ex) - 1).bit_length())
            pos_of[ex] = offset + np.arange(len(ex))
            offset += len(ex) + pad
            slot_user += [users[ex], np.zeros(pad, np.int64)]
            slot_item += [items[ex], np.zeros(pad, np.int64)]
            slot_mask += [np.ones(len(ex), np.float32), np.zeros(pad, np.float32)]
        self.slot_user = torch.as_tensor(np.concatenate(slot_user), device=device)
        self.slot_item = torch.as_tensor(np.concatenate(slot_item), device=device)
        self.slot_mask = torch.as_tensor(np.concatenate(slot_mask), device=device)
        self.slots = int(self.slot_user.numel())
        self.pos_of = torch.as_tensor(pos_of, device=device)
        self.users = torch.as_tensor(users, device=device)
        self.items = torch.as_tensor(items, device=device)
        # where the padding passes 2% of the examples the epoch shuffles the
        # examples and reads each one's negatives from its slot
        self.slot_epoch = self.slots >= 2 and self.slots - self.n <= 0.02 * self.n

    def negatives(self, u01: torch.Tensor, K: int) -> torch.Tensor:
        """``[slots, K]`` negatives from the uniforms ``[slots, K + 2]``."""
        users = self.slot_user
        m = torch.clamp(self.num_items - self.degree[users], min=1).to(torch.int32)[:, None]
        r = torch.minimum((u01 * m).to(torch.int32), m - 1).to(torch.int64)
        below = torch.searchsorted(self.flat, (users[:, None] << 31) + r, right=True)
        draws = r + below - self.indptr[users][:, None]
        negs, spares = draws[:, :K], draws[:, K:K + SPARES]
        earlier = torch.tril(torch.ones(K, K, dtype=torch.bool, device=negs.device), -1)
        dup = ((negs[:, :, None] == negs[:, None, :]) & earlier).any(-1)
        dup_rank = torch.cumsum(dup.to(torch.int32), dim=1) - 1
        subst = torch.where(dup_rank == 0, spares[:, :1], spares[:, 1:2])
        negs = torch.where(dup & (dup_rank < SPARES), subst, negs)
        return torch.clamp(negs, max=self.num_items - 1)

    def epoch(self, seed: int, epoch: int, B: int, K: int) -> Dict[str, torch.Tensor]:
        g = epoch_generator(seed, epoch, self.device)
        keys = draw_keys(g)
        u01 = torch.rand((self.slots, K + SPARES), generator=g, device=self.device)
        n = self.slots if self.slot_epoch else self.n
        perm = feistel(keys, n)
        S = -(-n // B)
        tail = S * B - n
        idx = torch.cat([perm, perm[:1].repeat(tail)]) if tail else perm
        negs = self.negatives(u01, K)
        if self.slot_epoch:
            mask = self.slot_mask[idx].clone()
            users, items, negs = self.slot_user[idx], self.slot_item[idx], negs[idx]
        else:
            mask = torch.ones(S * B, dtype=torch.float32, device=self.device)
            users, items, negs = self.users[idx], self.items[idx], negs[self.pos_of[idx]]
        if tail:
            mask[n:] = 0
        return {'users': users.reshape(S, B), 'pos_items': items.reshape(S, B),
                'neg_items': negs.reshape(S, B, K), 'mask': mask.reshape(S, B)}


class ExplicitData:
    def __init__(self, users, items, ratings, num_users: int, num_items: int, device):
        self.users = torch.as_tensor(np.asarray(users, np.int64), device=device)
        self.items = torch.as_tensor(np.asarray(items, np.int64), device=device)
        self.ratings = torch.as_tensor(np.asarray(ratings, np.float32), device=device)
        self.num_users, self.num_items, self.n = num_users, num_items, len(users)
        self.device = device

    def epoch(self, seed: int, epoch: int, B: int) -> Dict[str, torch.Tensor]:
        keys = draw_keys(epoch_generator(seed, epoch, self.device))
        perm = feistel(keys, self.n)
        S = -(-self.n // B)
        pad = S * B - self.n
        idx = torch.cat([perm, perm[:1].repeat(pad)]) if pad else perm
        mask = torch.ones(S * B, dtype=torch.float32, device=self.device)
        if pad:
            mask[self.n:] = 0
        return {'users': self.users[idx].reshape(S, B), 'items': self.items[idx].reshape(S, B),
                'ratings': self.ratings[idx].reshape(S, B), 'mask': mask.reshape(S, B)}


# -------------------------------------------------------------- training

TABLES = ('user_embeddings', 'item_embeddings')


def _implicit_grads(p, batch, s, dtype):
    u = batch['users'][s]
    pos = batch['pos_items'][s]
    neg = batch['neg_items'][s]
    w = batch['mask'][s].to(dtype)
    ue, ie, ib = p['user_embeddings'], p['item_embeddings'], p['item_biases']
    ur = ue[u]
    pos_s = (ur * ie[pos]).sum(1) + ib[pos]
    neg_s = (ur[:, None, :] * ie[neg]).sum(2) + ib[neg]                  # [B, K]
    hard = torch.argmax(neg_s, dim=1)
    hard_item = neg.gather(1, hard[:, None])[:, 0]
    hard_s = neg_s.gather(1, hard[:, None])[:, 0]
    l = torch.relu(1 - (pos_s - hard_s))
    denom = torch.clamp(w.sum(), min=1.0)
    loss = ((l * w).sum() + (l * l * w).sum()) / denom
    dl = torch.where(l > 0, (1 + 2 * l) * w / denom, torch.zeros_like(l))   # d loss / d hard_s
    g = {name: torch.zeros_like(t) for name, t in p.items()}
    g['user_embeddings'].index_add_(0, u, dl[:, None] * (ie[hard_item] - ie[pos]))
    g['item_embeddings'].index_add_(0, pos, -dl[:, None] * ur)
    g['item_embeddings'].index_add_(0, hard_item, dl[:, None] * ur)
    g['item_biases'].index_add_(0, pos, -dl)
    g['item_biases'].index_add_(0, hard_item, dl)
    return loss, g


def _explicit_grads(p, batch, s, dtype, y_range):
    u, i = batch['users'][s], batch['items'][s]
    r = batch['ratings'][s].to(dtype)
    w = batch['mask'][s].to(dtype)
    ur, ir = p['user_embeddings'][u], p['item_embeddings'][i]
    x = (ur * ir).sum(1) + p['user_biases'][u] + p['item_biases'][i]
    if y_range is not None:
        sig = torch.sigmoid(x)
        pred = sig * (y_range[1] - y_range[0]) + y_range[0]
        dpred_dx = sig * (1 - sig) * (y_range[1] - y_range[0])
    else:
        pred, dpred_dx = x, torch.ones_like(x)
    denom = torch.clamp(w.sum(), min=1.0)
    loss = ((pred - r) ** 2 * w).sum() / denom
    dx = 2 * (pred - r) * w / denom * dpred_dx
    g = {name: torch.zeros_like(t) for name, t in p.items()}
    g['user_embeddings'].index_add_(0, u, dx[:, None] * ir)
    g['item_embeddings'].index_add_(0, i, dx[:, None] * ur)
    g['user_biases'].index_add_(0, u, dx)
    g['item_biases'].index_add_(0, i, dx)
    return loss, g


def train_epochs(init: Dict[str, torch.Tensor], epochs: List[Dict[str, torch.Tensor]], *,
                 feedback: str, lr: float, lr_bias: float, dtype=torch.float32,
                 y_range=None, drop_half: bool = False) -> dict:
    """Train ``init`` over the given epochs' batches.  Returns per epoch the
    mean step loss and the params; after the first epoch the tables' first
    moments and each bias's summed gradient.  ``dtype``: the precision of
    the tables, moments and arithmetic (float32 as configured; a lower one
    for the control).  ``drop_half``: a planted fault, each step's second
    half of rows left out and the mean taken over the rest.

    Runs under ``torch.use_deterministic_algorithms``: the gradients'
    ``index_add_`` then adds in a fixed order on the card, so a seed reads
    the same in every run."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train_epochs(init, epochs, feedback=feedback, lr=lr, lr_bias=lr_bias,
                             dtype=dtype, y_range=y_range, drop_half=drop_half)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _train_epochs(init, epochs, *, feedback, lr, lr_bias, dtype, y_range, drop_half) -> dict:
    p = {k: v.detach().to(dtype).clone() for k, v in init.items()}
    mu = {k: torch.zeros_like(p[k]) for k in TABLES}
    nu = {k: torch.zeros_like(p[k]) for k in TABLES}
    biases = [k for k in p if k not in TABLES]
    out = {'loss': [], 'params': [], 'moments': None, 'bias_grad_sum': None}
    t = 0
    for batches in epochs:
        if drop_half:
            mask = batches['mask'].clone()
            mask[:, mask.shape[1] // 2:] = 0
            batches = {**batches, 'mask': mask}
        S = batches['mask'].shape[0]
        losses = []
        grad_sum = {k: torch.zeros_like(p[k]) for k in biases}
        for s in range(S):
            t += 1
            if feedback == 'implicit':
                loss, g = _implicit_grads(p, batches, s, dtype)
            else:
                loss, g = _explicit_grads(p, batches, s, dtype, y_range)
            losses.append(loss.float())
            bc1, bc2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
            for k in TABLES:
                mu[k].mul_(ADAM_B1).add_(g[k], alpha=1 - ADAM_B1)
                nu[k].mul_(ADAM_B2).add_(g[k] * g[k], alpha=1 - ADAM_B2)
                p[k].sub_(lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS))
            for k in biases:
                grad_sum[k] += g[k]
                p[k].sub_(lr_bias * g[k])
        out['loss'].append(float(torch.stack(losses).mean()))
        out['params'].append({k: v.float().clone() for k, v in p.items()})
        if out['moments'] is None:
            out['moments'] = {k: mu[k].float().clone() for k in TABLES}
            out['bias_grad_sum'] = {k: v.float() for k, v in grad_sum.items()}
    return out


def first_state(record: dict, lr_bias: float, init: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The optimizer's view of the first epoch's gradients, a leaf each:
    the Adam first moments of the tables, and for the SGD biases the summed
    gradient, ``-(b_1 - b_0) / lr``."""
    out = dict(record['moments'])
    for k, v in record['params'][0].items():
        if k not in TABLES:
            out[k] = (init[k].to(v) - v) / lr_bias
    return out


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              ref_grad: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
    """Per leaf: ``| |prog| - |ref| |`` over ``max(|ref|, median leaf |ref|)``
    (norms in float64).  Leaves whose reference gradient (``ref_grad``) is
    under a thousandth of the median leaf's are left out: they move by
    round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    keep = list(ref)
    if ref_grad is not None:
        g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grad.items()}
        median_g = float(np.median(list(g.values())))
        keep = [k for k in ref if g[k] >= 1e-3 * median_g]
    median = float(np.median([norms[k] for k in keep]))
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
            / max(norms[k], median, 1e-30) for k in keep}
