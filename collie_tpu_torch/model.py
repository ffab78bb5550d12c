"""Import-path parity module: ``collie_tpu_torch.model`` mirrors
``collie.model`` (reference ``collie/model/__init__.py``) so reference users
can port ``from collie.model import CollieTrainer, MatrixFactorizationModel``
by swapping the package name.
"""
from collie_tpu_torch.models.base import BasePipeline, INTERACTIONS_LIKE_INPUT
from collie_tpu_torch.models.cold_start_matrix_factorization import ColdStartModel
from collie_tpu_torch.models.collaborative_metric_learning import CollaborativeMetricLearningModel
from collie_tpu_torch.models.deep_fm import DeepFM
from collie_tpu_torch.models.hybrid_matrix_factorization import HybridModel
from collie_tpu_torch.models.hybrid_pretrained_matrix_factorization import HybridPretrainedModel
from collie_tpu_torch.models.matrix_factorization import MatrixFactorizationModel
from collie_tpu_torch.models.mlp_matrix_factorization import MLPMatrixFactorizationModel
from collie_tpu_torch.models.multi_stage import MultiStagePipeline
from collie_tpu_torch.models.neural_collaborative_filtering import NeuralCollaborativeFiltering
from collie_tpu_torch.models.nonlinear_matrix_factorization import \
    NonlinearMatrixFactorizationModel
from collie_tpu_torch.ops.embeddings import scaled_embedding_init, zero_embedding_init
from collie_tpu_torch.training.trainer import CollieMinimalTrainer, CollieTrainer

__all__ = [
    'BasePipeline', 'ColdStartModel', 'CollaborativeMetricLearningModel',
    'CollieMinimalTrainer', 'CollieTrainer', 'DeepFM', 'HybridModel',
    'HybridPretrainedModel', 'INTERACTIONS_LIKE_INPUT', 'MLPMatrixFactorizationModel',
    'MatrixFactorizationModel', 'MultiStagePipeline', 'NeuralCollaborativeFiltering',
    'NonlinearMatrixFactorizationModel', 'scaled_embedding_init', 'zero_embedding_init',
]
