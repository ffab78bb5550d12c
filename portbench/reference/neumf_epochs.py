"""Plain reference of the first epochs of a NeuMF fit, in plain torch: the
training of the epochs' batches (worked out again from the seed as an MF
fit's are, ``mf_epochs.ImplicitData``), and single steps from a given state.

Imports nothing of the package under test.  It restates NeuMF as
arXiv:1708.05031 defines it and as ``collie_tpu_torch`` documents it for a
whole-epoch fit of a ``NeuralCollaborativeFiltering`` with an adaptive loss:

* **Model**: a GMF branch, ``u_cf * i_cf`` of D-wide rows, beside an MLP
  branch, ``concat(u_mlp, i_mlp)`` of ``D 2^(L-1)``-wide rows per side
  through L ``Linear`` + ReLU layers that halve the width; the predict layer
  is one ``Linear(concat(gmf, mlp)) -> 1``, with no final activation.
  Weights are ``[in, out]`` (``x @ W + b``), under the program's leaf names.
* **Loss**, per step: the K negatives scored without gradient, each row's
  hardest negative the first maximum; the positive and that negative scored
  again with gradient; collie's composite hinge
  ``(sum l w + sum l^2 w) / max(sum w, 1)`` with ``l = relu(1 - pos + neg)``
  and the mask as the weights ``w``.
* **Update**: gradients by autograd on the named leaves, then optax Adam
  (0.9, 0.999, 1e-8, ``eps`` outside the root) on every leaf, densely, each
  step.  The plateau scheduler cannot cut the rate before epoch 4, so
  epochs 1-3 train at the initial rate.

Departures from the paper, each the package's own: collie's adaptive hinge
over K sampled negatives in place of the paper's pointwise log loss; no
pre-training of the GMF and MLP branches (the model's own initializer).
Collie's rule of ``D 2^(L-1)`` MLP rows per side gives the paper's twice
the factors at L = 2 (its section 4.1: factors 8, embeddings 16, layers
32 -> 16 -> 8).

Runs in float32 with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` False) and under
``torch.use_deterministic_algorithms``, so a seed reads the same in every
run; the settings are restored on return.  Imports only typing, numpy and
torch.
"""
from typing import Dict, List, Optional

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def scores(p: Dict[str, torch.Tensor], users: torch.Tensor, items: torch.Tensor,
           num_layers: int) -> torch.Tensor:
    """``[R, B]`` scores of the users ``[B]`` against the items ``[R, B]``."""
    R, B = items.shape
    u_mlp = p['user_embeddings_mlp'][users]
    x = torch.cat([u_mlp[None].expand(R, B, u_mlp.shape[-1]),
                   p['item_embeddings_mlp'][items]], dim=-1)
    for i in range(num_layers):
        x = torch.relu(x @ p[f'mlp_{i}_weight'] + p[f'mlp_{i}_bias'])
    gmf = p['user_embeddings_cf'][users][None] * p['item_embeddings_cf'][items]
    return (torch.cat([gmf, x], dim=-1) @ p['predict_weight'] + p['predict_bias'])[..., 0]


def _step_grads(p, batch, num_layers, dtype):
    """One step's loss and gradients; ``batch`` holds one step's rows."""
    users = batch['users'].long()
    pos = batch['pos_items'].long()
    neg = batch['neg_items'].long().T                                      # [K, B]
    w = batch['mask'].to(dtype)
    with torch.no_grad():
        hard = neg[torch.argmax(scores(p, users, neg, num_layers), dim=0),
                   torch.arange(neg.shape[1], device=neg.device)]
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    pos_s, neg_s = scores(leaves, users, torch.stack([pos, hard]), num_layers)
    l = torch.relu(1 - (pos_s - neg_s))
    loss = ((l * w).sum() + (l * l * w).sum()) / torch.clamp(w.sum(), min=1.0)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _adam_step(p, mu, nu, t, batch, *, lr, num_layers, dtype, drop_half):
    """The ``t``-th Adam step (counting from 1) on one step's rows, in place
    on ``p``, ``mu`` and ``nu``; returns the step's loss."""
    if drop_half:
        mask = batch['mask'].clone()
        mask[mask.shape[0] // 2:] = 0
        batch = {**batch, 'mask': mask}
    loss, g = _step_grads(p, batch, num_layers, dtype)
    bc1, bc2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
    with torch.no_grad():
        for k in p:
            mu[k].mul_(ADAM_B1).add_(g[k], alpha=1 - ADAM_B1)
            nu[k].mul_(ADAM_B2).add_(g[k] * g[k], alpha=1 - ADAM_B2)
            p[k].sub_(lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS))
    return loss


class _Settings:
    """TF32 as asked (off but for the control) and deterministic algorithms
    on, both restored on exit.  On a card, deterministic cuBLAS products need
    ``CUBLAS_WORKSPACE_CONFIG`` set in the environment (the caller's part)."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                    torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.use_deterministic_algorithms(True)
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.was[:2]
        torch.use_deterministic_algorithms(self.was[2], warn_only=self.was[3])
        return False


def train_epochs(init: Dict[str, torch.Tensor], epochs: List[Dict[str, torch.Tensor]], *,
                 lr: float, num_layers: int, dtype=torch.float32, tf32: bool = False,
                 drop_half: bool = False) -> dict:
    """Train ``init`` over the given epochs' batches (``[S, ...]`` tensors)
    from a fresh Adam state.  Returns per epoch the mean step loss and the
    params, and every leaf's Adam first moment after the first.  ``dtype``:
    the precision of the params, moments and arithmetic (float32 as
    configured; bfloat16 for a control); ``tf32``: the matmuls in TF32 (a
    control); ``drop_half``: a planted fault, each step's second half of
    rows left out and the mean taken over the rest."""
    p = {k: v.detach().to(dtype).clone() for k, v in init.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out: dict = {'loss': [], 'params': [], 'moments': None}
    t = 0
    with _Settings(tf32):
        for batches in epochs:
            losses = []
            for s in range(batches['mask'].shape[0]):
                t += 1
                losses.append(_adam_step(p, mu, nu, t, {k: v[s] for k, v in batches.items()},
                                         lr=lr, num_layers=num_layers, dtype=dtype,
                                         drop_half=drop_half).float())
            out['loss'].append(float(torch.stack(losses).mean()))
            out['params'].append({k: v.float().clone() for k, v in p.items()})
            if out['moments'] is None:
                out['moments'] = {k: v.float().clone() for k, v in mu.items()}
    return out


def step(state: dict, batch: Dict[str, torch.Tensor], *, lr: float, num_layers: int,
         dtype=torch.float32, tf32: bool = False, drop_half: bool = False) -> dict:
    """One Adam step from ``state`` (``params``, ``mu``, ``nu`` by leaf and
    ``t``, the steps taken before it) on one step's rows ``batch``; returns
    the state after it, with the step's ``loss``.  ``dtype``, ``tf32`` and
    ``drop_half`` as for ``train_epochs``."""
    p = {k: v.detach().to(dtype).clone() for k, v in state['params'].items()}
    mu = {k: v.to(dtype).clone() for k, v in state['mu'].items()}
    nu = {k: v.to(dtype).clone() for k, v in state['nu'].items()}
    with _Settings(tf32):
        loss = _adam_step(p, mu, nu, int(state['t']) + 1, batch, lr=lr, num_layers=num_layers,
                          dtype=dtype, drop_half=drop_half)
    return {'params': {k: v.float() for k, v in p.items()},
            'mu': {k: v.float() for k, v in mu.items()},
            'nu': {k: v.float() for k, v in nu.items()}, 'loss': float(loss)}


def leaf_errors(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                ref_grad: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
    """Per leaf: ``|prog - ref|`` over ``max(|ref|, median leaf |ref|)``
    (norms in float64), the leaves chosen as ``mf_epochs.leaf_gaps`` does.
    Unlike a gap of norms it sees every element: a changed direction reads
    as much as a changed length."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    keep = list(ref)
    if ref_grad is not None:
        g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grad.items()}
        median_g = float(np.median(list(g.values())))
        keep = [k for k in ref if g[k] >= 1e-3 * median_g]
    median = float(np.median([norms[k] for k in keep]))
    return {k: float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
            / max(norms[k], median, 1e-30) for k in keep}
