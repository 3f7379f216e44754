"""Models and the trainer (port of ``mila_tpu/models``)."""

from mila_tpu_torch.models.cnn_classifier import CNNClassifier, CNNClassifierConfig
from mila_tpu_torch.models.mlp_classifier import MLPClassifier, MLPClassifierConfig, accuracy
from mila_tpu_torch.models.model import Model, ModelConfig, TrainingHistory

__all__ = [
    "CNNClassifier",
    "CNNClassifierConfig",
    "MLPClassifier",
    "MLPClassifierConfig",
    "accuracy",
    "Model",
    "ModelConfig",
    "TrainingHistory",
]
