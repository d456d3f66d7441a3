"""AlexNet (counterpart of singa_tpu/models/alexnet.py)."""

from __future__ import annotations

from .. import layer
from .base import Classifier


class AlexNet(Classifier):

    def __init__(self, num_classes=10, num_channels=1):
        super().__init__(num_classes)
        self.num_channels = num_channels
        self.input_size = 224
        self.dimension = 4
        self.conv1 = layer.Conv2d(num_channels, 64, 11, stride=4, padding=2)
        self.conv2 = layer.Conv2d(64, 192, 5, padding=2)
        self.conv3 = layer.Conv2d(192, 384, 3, padding=1)
        self.conv4 = layer.Conv2d(384, 256, 3, padding=1)
        self.conv5 = layer.Conv2d(256, 256, 3, padding=1)
        self.linear1 = layer.Linear(4096)
        self.linear2 = layer.Linear(4096)
        self.linear3 = layer.Linear(num_classes)
        self.pooling1 = layer.MaxPool2d(2, 2, padding=0)
        self.pooling2 = layer.MaxPool2d(2, 2, padding=0)
        self.pooling3 = layer.MaxPool2d(2, 2, padding=0)
        self.avg_pooling1 = layer.AvgPool2d(3, 2, padding=0)
        self.relu = layer.ReLU()
        self.flatten = layer.Flatten()
        self.dropout1 = layer.Dropout()
        self.dropout2 = layer.Dropout()

    def forward(self, x):
        y = self.pooling1(self.relu(self.conv1(x)))
        y = self.pooling2(self.relu(self.conv2(y)))
        y = self.relu(self.conv3(y))
        y = self.relu(self.conv4(y))
        y = self.pooling3(self.relu(self.conv5(y)))
        y = self.avg_pooling1(y)
        y = self.flatten(y)
        y = self.relu(self.linear1(self.dropout1(y)))
        y = self.relu(self.linear2(self.dropout2(y)))
        return self.linear3(y)


def create_model(pretrained=False, **kwargs):
    return AlexNet(**kwargs)


__all__ = ["AlexNet", "create_model"]
