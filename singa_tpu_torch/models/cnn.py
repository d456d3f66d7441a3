"""LeNet-style CNN for MNIST (counterpart of singa_tpu/models/cnn.py)."""

from __future__ import annotations

from .. import layer
from .base import Classifier


class CNN(Classifier):

    def __init__(self, num_classes=10, num_channels=1):
        super().__init__(num_classes)
        self.num_channels = num_channels
        self.input_size = 28
        self.dimension = 4
        # the legacy call style Conv2d(in, out, k), with a fused relu
        self.conv1 = layer.Conv2d(num_channels, 20, 5, padding=0,
                                  activation="RELU")
        self.conv2 = layer.Conv2d(20, 50, 5, padding=0, activation="RELU")
        self.linear1 = layer.Linear(500)
        self.linear2 = layer.Linear(num_classes)
        self.pooling1 = layer.MaxPool2d(2, 2, padding=0)
        self.pooling2 = layer.MaxPool2d(2, 2, padding=0)
        self.relu = layer.ReLU()
        self.flatten = layer.Flatten()

    def forward(self, x):
        y = self.conv1(x)
        y = self.pooling1(y)
        y = self.conv2(y)
        y = self.pooling2(y)
        y = self.flatten(y)
        y = self.linear1(y)
        y = self.relu(y)
        return self.linear2(y)


def create_model(pretrained=False, **kwargs):
    return CNN(**kwargs)


__all__ = ["CNN", "create_model"]
