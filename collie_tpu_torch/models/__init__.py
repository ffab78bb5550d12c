"""Models: ``nn.Module`` pipelines with a functional scoring API."""
from collie_tpu_torch.models.base import BasePipeline, INTERACTIONS_LIKE_INPUT
from collie_tpu_torch.models.matrix_factorization import MatrixFactorizationModel

__all__ = ['BasePipeline', 'INTERACTIONS_LIKE_INPUT', 'MatrixFactorizationModel']
