"""collie_tpu_torch: the PyTorch / CUDA port of ``collie_tpu``.

A second package beside the JAX one, with its layout and public names
(``data/``, ``ops/``, ``models/``, ``evaluate.py``, ``retrieval.py``) and
the same hyperparameters, flat param names and npz model format.  It runs on
a CUDA device unless the caller asks for the CPU (``map_location='cpu'``),
and its kernels are hand-written CUDA (``csrc/``).  Ported so far: the
serving path of ``MatrixFactorizationModel`` (data, model construction and
npz load, ``recommend``, ``evaluate_in_batches``) and its training path
(``CollieTrainer.fit`` on in-memory implicit loaders, through the fused
epoch kernel on the card).

Everything is re-exported flat from this module.
"""
from collie_tpu_torch._version import __version__

from collie_tpu_torch.config import DATA_PATH
from collie_tpu_torch.data import (BaseInteractions,
                                   BaseInteractionsDataLoader,
                                   ExplicitInteractions,
                                   Interactions,
                                   InteractionsDataLoader,
                                   NegativeSampler,
                                   random_split,
                                   stratified_split)
from collie_tpu_torch.evaluate import evaluate_in_batches, get_preds
from collie_tpu_torch.models import BasePipeline, MatrixFactorizationModel
from collie_tpu_torch.ops import auc, mapk, mrr
from collie_tpu_torch.retrieval import build_retrieval_fn, recommend
from collie_tpu_torch.training import (CollieMinimalTrainer, CollieTrainer,
                                       ReduceLROnPlateau, StepLR)
from collie_tpu_torch.utils import (convert_to_implicit,
                                    get_init_arguments,
                                    get_random_seed,
                                    merge_docstrings)
from collie_tpu_torch.weights import optimizer_state_from_jax, params_from_jax

__all__ = [
    '__version__', 'DATA_PATH', 'BaseInteractions', 'BaseInteractionsDataLoader',
    'BasePipeline', 'CollieMinimalTrainer', 'CollieTrainer', 'ExplicitInteractions', 'Interactions', 'InteractionsDataLoader',
    'MatrixFactorizationModel', 'NegativeSampler', 'ReduceLROnPlateau', 'StepLR',
    'auc', 'build_retrieval_fn', 'convert_to_implicit', 'evaluate_in_batches',
    'get_init_arguments', 'get_preds', 'get_random_seed', 'mapk',
    'merge_docstrings', 'mrr', 'optimizer_state_from_jax', 'params_from_jax', 'random_split', 'recommend',
    'stratified_split',
]
