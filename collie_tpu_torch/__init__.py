"""collie_tpu_torch: the PyTorch / CUDA port of ``collie_tpu``.

A second package beside the JAX one, with its layout and public names
(``data/``, ``ops/``, ``models/``, ``evaluate.py``, ``retrieval.py``) and
the same hyperparameters, flat param names and npz model format.  It runs on
a CUDA device unless the caller asks for the CPU (``map_location='cpu'``),
and its kernels are hand-written CUDA (``csrc/``).  Ported so far: the
serving path of ``MatrixFactorizationModel`` (data, model construction and
npz load, ``recommend``, ``evaluate_in_batches``) and its training paths
(``CollieTrainer.fit`` on in-memory implicit loaders and on explicit ratings
with MSE/MAE and ``y_range``, through the fused epoch kernels on the card;
``explicit_evaluate_in_batches``), embedding dropout, and the single-stage
model zoo (``MLPMatrixFactorizationModel``,
``NonlinearMatrixFactorizationModel``, ``NeuralCollaborativeFiltering``,
``DeepFM``, ``CollaborativeMetricLearningModel``) and the multi-stage
models (``MultiStagePipeline``, ``ColdStartModel``, ``HybridModel``,
``HybridPretrainedModel``, trained stage by stage), all trained through the
generic autograd epoch and served through the blockwise retrieval path.

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
from collie_tpu_torch.evaluate import (evaluate_in_batches, explicit_evaluate_in_batches,
                                      get_preds)
from collie_tpu_torch.models import (BasePipeline, ColdStartModel,
                                     CollaborativeMetricLearningModel, DeepFM, HybridModel,
                                     HybridPretrainedModel, MatrixFactorizationModel,
                                     MLPMatrixFactorizationModel, MultiStagePipeline,
                                     NeuralCollaborativeFiltering,
                                     NonlinearMatrixFactorizationModel)
from collie_tpu_torch.ops import (adaptive_bpr_loss, adaptive_hinge_loss, auc, bpr_loss,
                                  hinge_loss, ideal_difference_from_metadata, mae_loss, mapk,
                                  mrr, mse_loss, warp_loss)
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
    'BasePipeline', 'ColdStartModel', 'CollaborativeMetricLearningModel',
    'CollieMinimalTrainer', 'CollieTrainer', 'DeepFM', 'ExplicitInteractions',
    'HybridModel', 'HybridPretrainedModel', 'Interactions', 'InteractionsDataLoader',
    'MLPMatrixFactorizationModel', 'MatrixFactorizationModel', 'MultiStagePipeline',
    'NegativeSampler', 'NeuralCollaborativeFiltering', 'NonlinearMatrixFactorizationModel',
    'ReduceLROnPlateau', 'StepLR', 'adaptive_bpr_loss', 'adaptive_hinge_loss', 'auc',
    'bpr_loss', 'build_retrieval_fn', 'convert_to_implicit', 'evaluate_in_batches',
    'explicit_evaluate_in_batches', 'get_init_arguments', 'get_preds', 'get_random_seed',
    'hinge_loss', 'ideal_difference_from_metadata', 'mae_loss', 'mapk', 'merge_docstrings',
    'mrr', 'mse_loss', 'optimizer_state_from_jax', 'params_from_jax', 'random_split',
    'recommend', 'stratified_split', 'warp_loss',
]
