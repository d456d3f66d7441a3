"""Two-layer perceptron (counterpart of singa_tpu/models/mlp.py)."""

from __future__ import annotations

from .. import layer
from .base import Classifier


class MLP(Classifier):

    def __init__(self, data_size=10, perceptron_size=100, num_classes=10):
        super().__init__(num_classes)
        self.dimension = 2
        self.data_size = data_size
        self.relu = layer.ReLU()
        self.linear1 = layer.Linear(perceptron_size)
        self.linear2 = layer.Linear(num_classes)

    def forward(self, inputs):
        y = self.linear1(inputs)
        y = self.relu(y)
        return self.linear2(y)


def create_model(pretrained=False, **kwargs):
    return MLP(**kwargs)


__all__ = ["MLP", "create_model"]
