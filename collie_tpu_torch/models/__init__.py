"""Models: ``nn.Module`` pipelines with a functional scoring API."""
from collie_tpu_torch.models.base import BasePipeline, INTERACTIONS_LIKE_INPUT
from collie_tpu_torch.models.collaborative_metric_learning import \
    CollaborativeMetricLearningModel
from collie_tpu_torch.models.deep_fm import DeepFM
from collie_tpu_torch.models.matrix_factorization import MatrixFactorizationModel
from collie_tpu_torch.models.mlp_matrix_factorization import MLPMatrixFactorizationModel
from collie_tpu_torch.models.neural_collaborative_filtering import NeuralCollaborativeFiltering
from collie_tpu_torch.models.nonlinear_matrix_factorization import \
    NonlinearMatrixFactorizationModel

__all__ = ['BasePipeline', 'CollaborativeMetricLearningModel', 'DeepFM',
           'INTERACTIONS_LIKE_INPUT', 'MLPMatrixFactorizationModel', 'MatrixFactorizationModel',
           'NeuralCollaborativeFiltering', 'NonlinearMatrixFactorizationModel']
