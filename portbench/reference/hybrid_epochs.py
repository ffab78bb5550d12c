"""Plain reference of single training steps of collie's staged
``HybridModel``, in plain torch, from a given state.

Imports nothing of either package (``collie_tpu``, ``collie_tpu_torch``).
It restates the model as collie's ``hybrid_matrix_factorization.py``
defines it and as ``collie_tpu_torch`` documents it for a whole-epoch fit
with an adaptive loss and no metadata towers:

* **Scores.** In the ``matrix_factorization`` stage the MF dot product
  ``u . i + b_u + b_i``.  In the later stages a combined MLP over
  ``concat(u, i, item_metadata[i])``: each hidden layer ``x @ W + b``
  (weights ``[in, out]``) then leaky ReLU (slope 0.01), the last layer
  ``x @ W + b`` to one unit, then ``+ b_u + b_i``.  A row's user-side rows
  (embedding and bias) are gathered once and broadcast over its items.
* **Loss**, per step: the K negatives scored without gradient, each row's
  hardest negative the first maximum; the positive and that negative
  scored again with gradient; collie's composite hinge
  ``(sum l w + sum l^2 w) / max(sum w, 1)`` with ``l = relu(1 - pos + neg)``
  and the mask as the weights ``w``.
* **Stages** (collie's optimizer layout):
  ``matrix_factorization`` trains the embedding tables with Adam at ``lr``
  and the biases with SGD at ``bias_lr``; ``metadata_only`` trains the
  combined layers and the biases with Adam at ``metadata_only_stage_lr``,
  the tables frozen; ``all`` trains every leaf with Adam at
  ``all_stage_lr``.  A frozen leaf gets no update.  Each stage's fit starts
  a fresh optimizer state.
* **Update**: optax's Adam (0.9, 0.999, 1e-8, ``eps`` outside the root,
  bias corrections ``1 - b^t`` in float32), densely on every trained leaf;
  SGD ``p - lr g``.

Runs in float32 with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` False) and under
``torch.use_deterministic_algorithms``, so a seed reads the same in every
run; the settings are restored on return.  Imports only typing, numpy and
torch.
"""
from typing import Dict, Tuple

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
TABLES = ('user_embeddings', 'item_embeddings')
BIASES = ('user_biases', 'item_biases')


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


def trained_leaves(stage: str, names, leak: bool = False) -> Tuple[tuple, tuple]:
    """``(adam, sgd)``: the leaves ``stage`` trains by each optimizer.
    ``leak`` (a planted fault): ``metadata_only`` trains the tables too."""
    names = sorted(names)
    if stage == 'matrix_factorization':
        return TABLES, BIASES
    if stage == 'metadata_only':
        frozen = () if leak else TABLES
        return tuple(k for k in names if k not in frozen), ()
    if stage == 'all':
        return tuple(names), ()
    raise ValueError(f'unknown stage {stage!r}')


def _num_layers(p: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in p if k.startswith('combined_layer_') and k.endswith('_weight'))


def scores(p: Dict[str, torch.Tensor], metadata: torch.Tensor, users: torch.Tensor,
           items: torch.Tensor, stage: str) -> torch.Tensor:
    """``[R, B]`` scores of the users ``[B]`` against the items ``[R, B]``."""
    R, B = items.shape
    user = p['user_embeddings'][users]                                       # [B, D]
    item = p['item_embeddings'][items]                                       # [R, B, D]
    biases = p['user_biases'][users][None] + p['item_biases'][items]
    if stage == 'matrix_factorization':
        return (user[None] * item).sum(dim=-1) + biases
    meta = metadata[items.clamp(0, metadata.shape[0] - 1)]                    # [R, B, F]
    x = torch.cat([user[None].expand(R, B, user.shape[-1]), item, meta], dim=-1)
    last = _num_layers(p) - 1
    for i in range(last):
        x = torch.nn.functional.leaky_relu(
            x @ p[f'combined_layer_{i}_weight'] + p[f'combined_layer_{i}_bias'], 0.01)
    return (x @ p[f'combined_layer_{last}_weight']
            + p[f'combined_layer_{last}_bias'])[..., 0] + biases


def _step_grads(p, metadata, batch, stage, trained, dtype):
    """One step's loss and the gradients of the ``trained`` leaves."""
    users = batch['users'].long()
    pos = batch['pos_items'].long()
    neg = batch['neg_items'].long().T                                      # [K, B]
    w = batch['mask'].to(dtype)
    with torch.no_grad():
        hard = neg[torch.argmax(scores(p, metadata, users, neg, stage), dim=0),
                   torch.arange(neg.shape[1], device=neg.device)]
    leaves = {k: (v.detach().requires_grad_() if k in trained else v.detach())
              for k, v in p.items()}
    pos_s, neg_s = scores(leaves, metadata, users, torch.stack([pos, hard]), stage)
    l = torch.relu(1 - (pos_s - neg_s))
    loss = ((l * w).sum() + (l * l * w).sum()) / torch.clamp(w.sum(), min=1.0)
    grads = torch.autograd.grad(loss, [leaves[k] for k in trained])
    return loss.detach(), dict(zip(trained, grads))


def step(state: dict, batch: Dict[str, torch.Tensor], *, stage: str,
         metadata: torch.Tensor, rates: Dict[str, float], dtype=torch.float32,
         tf32: bool = False, drop_half: bool = False, leak: bool = False) -> dict:
    """One step of ``stage`` from ``state`` (``params`` by leaf, the Adam
    ``mu`` and ``nu`` of the stage's Adam leaves, ``t`` the Adam steps taken
    before it) on one step's rows ``batch`` (``users``, ``pos_items`` ``[B]``,
    ``neg_items [B, K]``, ``mask``).  ``rates``: the configuration's ``lr``,
    ``bias_lr``, ``metadata_only_stage_lr`` and ``all_stage_lr``.  Returns
    the ``params``, ``mu`` and ``nu`` after it, the step's ``loss`` and the
    ``grads`` of the trained leaves.  ``dtype``: the precision of the
    params, moments, metadata and arithmetic (float32 as configured;
    bfloat16 for a control); ``tf32``: the matmuls in TF32 (a control);
    ``drop_half`` (a planted fault): each step's second half of rows left
    out; ``leak`` (a planted fault): ``metadata_only`` trains the tables
    too, from zero moments."""
    adam, sgd = trained_leaves(stage, state['params'], leak)
    lr = {'matrix_factorization': rates['lr'], 'metadata_only': rates['metadata_only_stage_lr'],
          'all': rates['all_stage_lr']}[stage]
    p = {k: v.detach().to(dtype).clone() for k, v in state['params'].items()}
    mu = {k: (state['mu'][k].to(dtype).clone() if k in state['mu'] else torch.zeros_like(p[k]))
          for k in adam}
    nu = {k: (state['nu'][k].to(dtype).clone() if k in state['nu'] else torch.zeros_like(p[k]))
          for k in adam}
    if drop_half:
        mask = batch['mask'].clone()
        mask[mask.shape[0] // 2:] = 0
        batch = {**batch, 'mask': mask}
    with _Settings(tf32):
        loss, g = _step_grads(p, metadata.to(dtype), batch, stage, adam + sgd, dtype)
        t = torch.tensor(float(int(state['t']) + 1), dtype=torch.float32, device=loss.device)
        bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32, device=t.device) ** t
        bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32, device=t.device) ** t
        with torch.no_grad():
            for k in adam:
                mu[k] = (1 - ADAM_B1) * g[k] + ADAM_B1 * mu[k]
                nu[k] = (1 - ADAM_B2) * (g[k] * g[k]) + ADAM_B2 * nu[k]
                p[k] = p[k] + ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)) * (-lr)
            for k in sgd:
                p[k] = p[k] + g[k] * (-rates['bias_lr'])
    return {'params': {k: v.float() for k, v in p.items()},
            'mu': {k: v.float() for k, v in mu.items()},
            'nu': {k: v.float() for k, v in nu.items()},
            'grads': {k: v.float() for k, v in g.items()}, 'loss': float(loss)}


def leaf_errors(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                ref_grad: Dict[str, torch.Tensor], frozen=()) -> Dict[str, float]:
    """Per leaf: ``|prog - ref|`` over ``max(|ref|, median leaf |ref|)``
    (norms in float64), over the leaves of ``ref_grad`` whose reference
    gradient is at least a thousandth of the median leaf's (a leaf a
    pairwise loss gives only rounding noise, as the user biases and the last
    layer's bias, is left out), and over the ``frozen`` leaves, whose
    reference value is 0 and whose program value reads over the median."""
    g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grad.items()}
    median_g = float(np.median(list(g.values())))
    keep = [k for k in ref_grad if g[k] >= 1e-3 * median_g]
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    median = float(np.median(list(norms.values())))
    return {k: float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
            / max(norms.get(k, 0.0), median, 1e-30) for k in list(keep) + list(frozen)}


def step_numbers(before: Dict[str, torch.Tensor], ref: dict, got: dict) -> Dict[str, float]:
    """The compared numbers of a step's result ``got`` (``params``, ``mu``,
    ``loss``) against the reference's ``ref``, both from the leaves
    ``before``: the loss's relative gap, the Adam first moments' and every
    leaf's change's worst ``leaf_errors`` (the stage's frozen leaves held to
    no change)."""
    grads = ref['grads']
    adam = list(ref['mu'])
    frozen = [k for k in before if k not in grads]
    ref_delta = {k: ref['params'][k] - before[k] for k in before}
    got_delta = {k: got['params'][k].float() - before[k] for k in before}
    return {'step_loss_gap': abs(got['loss'] - ref['loss']) / abs(ref['loss']),
            'step_grad_err': max(leaf_errors(got['mu'], ref['mu'],
                                             {k: grads[k] for k in adam}).values()),
            'step_delta_err': max(leaf_errors(got_delta, ref_delta, grads,
                                              frozen).values())}
