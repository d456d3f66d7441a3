"""Xception (counterpart of singa_tpu/models/xceptionnet.py): depthwise
separable convs are grouped convolutions."""

from __future__ import annotations

from .. import layer
from .base import Classifier


class Block(layer.Layer):
    """rep x (ReLU -> SeparableConv 3x3 -> BN) with a 1x1-conv skip."""

    def __init__(self, out_filters, reps, strides=1, padding=0,
                 start_with_relu=True, grow_first=True, in_equals_out=False):
        super().__init__()
        self.strides = strides
        self.need_skip = (not in_equals_out) or strides != 1
        if self.need_skip:
            self.skip = layer.Conv2d(out_filters, 1, stride=strides,
                                     padding=padding, bias=False)
            self.skipbn = layer.BatchNorm2d(out_filters)

        body = []
        if grow_first:
            body += [layer.ReLU(),
                     layer.SeparableConv2d(out_filters, 3, stride=1,
                                           padding=1),
                     layer.BatchNorm2d(out_filters)]
        for _ in range(reps - 1):
            body += [layer.ReLU(),
                     layer.SeparableConv2d(out_filters if grow_first else None,
                                           3, stride=1, padding=1),
                     layer.BatchNorm2d(out_filters)]
        if not grow_first:
            body += [layer.ReLU(),
                     layer.SeparableConv2d(out_filters, 3, stride=1,
                                           padding=1),
                     layer.BatchNorm2d(out_filters)]
        if not start_with_relu:
            body = body[1:]
        if strides != 1:
            body.append(layer.MaxPool2d(3, strides, padding + 1))
        self.body = body
        self.register_layers(*body)
        self.add = layer.Add()

    def forward(self, x):
        y = x
        for lyr in self.body:
            y = lyr(y)
        skip = self.skipbn(self.skip(x)) if self.need_skip else x
        return self.add(y, skip)


class Xception(Classifier):

    def __init__(self, num_classes=10, num_channels=3):
        super().__init__(num_classes)
        self.num_channels = num_channels
        self.input_size = 299
        self.dimension = 4

        self.conv1 = layer.Conv2d(32, 3, stride=2, padding=0, bias=False)
        self.bn1 = layer.BatchNorm2d(32)
        self.conv2 = layer.Conv2d(64, 3, stride=1, padding=1, bias=False)
        self.bn2 = layer.BatchNorm2d(64)
        self.relu = layer.ReLU()

        self.block1 = Block(128, 2, 2, padding=0, start_with_relu=False)
        self.block2 = Block(256, 2, 2, padding=0)
        self.block3 = Block(728, 2, 2, padding=0)
        mids = [Block(728, 3, 1, in_equals_out=True) for _ in range(8)]
        self.mids = mids
        self.register_layers(*mids)
        self.block12 = Block(1024, 2, 2, grow_first=False)

        self.conv3 = layer.SeparableConv2d(1536, 3, stride=1, padding=1)
        self.bn3 = layer.BatchNorm2d(1536)
        self.conv4 = layer.SeparableConv2d(2048, 3, stride=1, padding=1)
        self.bn4 = layer.BatchNorm2d(2048)
        self.globalpooling = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(num_classes)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.block1(y)
        y = self.block2(y)
        y = self.block3(y)
        for b in self.mids:
            y = b(y)
        y = self.block12(y)
        y = self.relu(self.bn3(self.conv3(y)))
        y = self.relu(self.bn4(self.conv4(y)))
        y = self.globalpooling(y)
        return self.fc(y)


def create_model(pretrained=False, **kwargs):
    return Xception(**kwargs)


__all__ = ["Xception", "Block", "create_model"]
