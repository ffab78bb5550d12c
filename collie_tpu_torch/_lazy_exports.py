"""Lazy attribute resolution for the flat ``collie_tpu_torch`` namespace.

The keys are ``collie_tpu._lazy_exports.EXPORTS``'s, each mapped to the
port's module that defines the name.  The package imports most of them
eagerly; ``__getattr__`` in ``collie_tpu_torch/__init__.py`` resolves the
rest here on first use, so importing the package does not import
``collie_tpu_torch.parallel``.
"""
import importlib

# name -> module path providing it
EXPORTS = {
    # evaluation drivers + host metric wrappers
    'auc': 'collie_tpu_torch.ops.metrics',
    'mapk': 'collie_tpu_torch.ops.metrics',
    'mrr': 'collie_tpu_torch.ops.metrics',
    'get_preds': 'collie_tpu_torch.evaluate',
    'evaluate_in_batches': 'collie_tpu_torch.evaluate',
    'explicit_evaluate_in_batches': 'collie_tpu_torch.evaluate',
    # pipeline core + trainers
    'BasePipeline': 'collie_tpu_torch.models.base',
    'MultiStagePipeline': 'collie_tpu_torch.models.multi_stage',
    'CollieTrainer': 'collie_tpu_torch.training.trainer',
    'CollieMinimalTrainer': 'collie_tpu_torch.training.trainer',
    # model zoo
    'MatrixFactorizationModel': 'collie_tpu_torch.models.matrix_factorization',
    'MLPMatrixFactorizationModel': 'collie_tpu_torch.models.mlp_matrix_factorization',
    'NonlinearMatrixFactorizationModel':
        'collie_tpu_torch.models.nonlinear_matrix_factorization',
    'NeuralCollaborativeFiltering': 'collie_tpu_torch.models.neural_collaborative_filtering',
    'DeepFM': 'collie_tpu_torch.models.deep_fm',
    'CollaborativeMetricLearningModel': 'collie_tpu_torch.models.collaborative_metric_learning',
    'HybridModel': 'collie_tpu_torch.models.hybrid_matrix_factorization',
    'HybridPretrainedModel': 'collie_tpu_torch.models.hybrid_pretrained_matrix_factorization',
    'ColdStartModel': 'collie_tpu_torch.models.cold_start_matrix_factorization',
    # serving / retrieval
    'recommend': 'collie_tpu_torch.retrieval',
    'build_retrieval_fn': 'collie_tpu_torch.retrieval',
    # mesh / sharding
    'make_mesh': 'collie_tpu_torch.parallel.mesh',
}


def resolve(name: str):
    module = importlib.import_module(EXPORTS[name])
    return getattr(module, name)
