"""collie_tpu_torch: the PyTorch / CUDA port of ``collie_tpu``.

A second package beside the JAX one, with its layout and public names
(``data/``, ``ops/``, ``models/``, ``evaluate.py``, ``retrieval.py``) and
the same hyperparameters, flat param names and npz model format.  It runs on
a CUDA device unless the caller asks for the CPU (``map_location='cpu'``),
and its kernels are hand-written CUDA (``csrc/``).  Ported so far: the
serving path of ``MatrixFactorizationModel`` (data, model construction and
npz load, ``recommend``, ``evaluate_in_batches``) and its training paths
(``CollieTrainer.fit`` on in-memory implicit loaders, exact or approximate,
and on explicit ratings with MSE/MAE and ``y_range``, through the fused
epoch kernels on the card, with the bucketed or CSR sampler;
``explicit_evaluate_in_batches``), the rest of the single-device trainer
(checkpoint/resume, JAX checkpoints included; the per-step path for
``epoch_mode='step'``, ``PrefetchLoader`` and custom loaders;
``CollieMinimalTrainer``; custom optimizer factories), the data-prep
helpers of ``utils``, embedding dropout, and the single-stage
model zoo (``MLPMatrixFactorizationModel``,
``NonlinearMatrixFactorizationModel``, ``NeuralCollaborativeFiltering``,
``DeepFM``, ``CollaborativeMetricLearningModel``) and the multi-stage
models (``MultiStagePipeline``, ``ColdStartModel``, ``HybridModel``,
``HybridPretrainedModel``, trained stage by stage), all trained through the
generic autograd epoch and served through the blockwise retrieval path, and
the out-of-core HDF5 tier (``HDF5Interactions``,
``HDF5InteractionsDataLoader``, ``write_hdf5_meta``, ``pandas_df_to_hdf5``
and ``CollieTrainer``'s chunk tier; ``h5py`` is imported only where a store
is read or written), the periphery (``movielens``, ``training.profiler``
and the reference's import paths ``loss``, ``metrics``, ``model``,
``interactions``, ``cross_validation``), and the parallel tier
(``parallel``: a ``torch.distributed`` device mesh, the sharding rules, the
sharded embedding lookup, ``recommend`` / ``evaluate_in_batches`` under
``mesh=``, ``CollieTrainer(mesh=)`` with row-sharded tables and moments,
and the per-shard ``.shards`` checkpoints).  After this the port does
everything the JAX package does.

Everything is re-exported flat from this module; ``make_mesh`` is resolved
on first use, so importing the package does not import ``parallel``.
"""
from collie_tpu_torch._version import __version__

from collie_tpu_torch.config import DATA_PATH
from collie_tpu_torch.data import (ApproximateNegativeSamplingInteractionsDataLoader,
                                   BaseInteractions,
                                   BaseInteractionsDataLoader,
                                   ExplicitInteractions,
                                   HDF5Interactions,
                                   HDF5InteractionsDataLoader,
                                   Interactions,
                                   InteractionsDataLoader,
                                   NegativeSampler,
                                   PrefetchLoader,
                                   random_split,
                                   stratified_split,
                                   write_hdf5_meta)
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
from collie_tpu_torch.utils import (Timer,
                                    convert_to_implicit,
                                    create_ratings_matrix,
                                    df_to_html,
                                    df_to_interactions,
                                    get_init_arguments,
                                    get_random_seed,
                                    merge_docstrings,
                                    pandas_df_to_hdf5,
                                    remove_users_with_fewer_than_n_interactions,
                                    trunc_normal)
from collie_tpu_torch.weights import optimizer_state_from_jax, params_from_jax, read_checkpoint

__all__ = [
    '__version__', 'DATA_PATH', 'ApproximateNegativeSamplingInteractionsDataLoader',
    'BaseInteractions', 'BaseInteractionsDataLoader',
    'BasePipeline', 'ColdStartModel', 'CollaborativeMetricLearningModel',
    'CollieMinimalTrainer', 'CollieTrainer', 'DeepFM', 'ExplicitInteractions',
    'HDF5Interactions', 'HDF5InteractionsDataLoader', 'HybridModel',
    'HybridPretrainedModel', 'Interactions', 'InteractionsDataLoader',
    'MLPMatrixFactorizationModel', 'MatrixFactorizationModel', 'MultiStagePipeline',
    'NegativeSampler', 'NeuralCollaborativeFiltering', 'NonlinearMatrixFactorizationModel',
    'PrefetchLoader', 'ReduceLROnPlateau', 'StepLR', 'Timer', 'adaptive_bpr_loss',
    'adaptive_hinge_loss', 'auc', 'bpr_loss', 'build_retrieval_fn', 'convert_to_implicit',
    'create_ratings_matrix', 'df_to_html', 'df_to_interactions', 'evaluate_in_batches',
    'explicit_evaluate_in_batches', 'get_init_arguments', 'get_preds', 'get_random_seed',
    'hinge_loss', 'ideal_difference_from_metadata', 'mae_loss', 'mapk', 'merge_docstrings',
    'mrr', 'mse_loss', 'optimizer_state_from_jax', 'pandas_df_to_hdf5', 'params_from_jax',
    'random_split', 'read_checkpoint', 'recommend',
    'remove_users_with_fewer_than_n_interactions', 'stratified_split', 'trunc_normal',
    'warp_loss', 'write_hdf5_meta', 'make_mesh',
]


def __getattr__(name):
    """Resolve the flat names this module does not import eagerly
    (``make_mesh``) through ``_lazy_exports``."""
    import importlib
    # ``from collie_tpu_torch import _lazy_exports`` would re-enter this
    # __getattr__; import_module targets the submodule directly
    lazy = importlib.import_module('collie_tpu_torch._lazy_exports')
    if name in lazy.EXPORTS:
        return lazy.resolve(name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
