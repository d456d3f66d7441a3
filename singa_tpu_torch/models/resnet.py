"""ResNet family (counterpart of singa_tpu/models/resnet.py), the repo's
headline training benchmark. `Downsample` is a real sublayer, so its
parameters are trained and checkpointed; each `_make_layer` stage list is
registered through `register_layers`, so the blocks carry the JAX
package's names (`Bottleneck_0`, then `Bottleneck_0_` for layer2's first
block, ...)."""

from __future__ import annotations

from .. import layer
from .base import Classifier


def conv3x3(out_planes, stride=1):
    return layer.Conv2d(out_planes, 3, stride=stride, padding=1, bias=False)


class Downsample(layer.Layer):
    def __init__(self, planes, stride):
        super().__init__()
        self.conv = layer.Conv2d(planes, 1, stride=stride, bias=False)
        self.bn = layer.BatchNorm2d(planes)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(layer.Layer):
    expansion = 1

    def __init__(self, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = conv3x3(planes, stride)
        self.bn1 = layer.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes)
        self.bn2 = layer.BatchNorm2d(planes)
        self.relu = layer.ReLU()
        self.add = layer.Add()
        self.downsample = downsample

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(self.add(out, residual))


class Bottleneck(layer.Layer):
    expansion = 4

    def __init__(self, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = layer.Conv2d(planes, 1, bias=False)
        self.bn1 = layer.BatchNorm2d(planes)
        self.conv2 = layer.Conv2d(planes, 3, stride=stride, padding=1,
                                  bias=False)
        self.bn2 = layer.BatchNorm2d(planes)
        self.conv3 = layer.Conv2d(planes * self.expansion, 1, bias=False)
        self.bn3 = layer.BatchNorm2d(planes * self.expansion)
        self.relu = layer.ReLU()
        self.add = layer.Add()
        self.downsample = downsample

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(self.add(out, residual))


class ResNet(Classifier):

    def __init__(self, block, layers, num_classes=10, num_channels=3):
        super().__init__(num_classes)
        self.num_channels = num_channels
        self.input_size = 224
        self.dimension = 4
        self.inplanes = 64
        self.conv1 = layer.Conv2d(64, 7, stride=2, padding=3, bias=False)
        self.bn1 = layer.BatchNorm2d(64)
        self.relu = layer.ReLU()
        self.maxpool = layer.MaxPool2d(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        self.avgpool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Downsample(planes * block.expansion, stride)
        stages = [block(planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        stages += [block(planes) for _ in range(1, blocks)]
        self.register_layers(*stages)

        def run(x, stages=stages):
            for b in stages:
                x = b(x)
            return x
        return run

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        return self.fc(x)


def resnet18(pretrained=False, **kwargs):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(Bottleneck, [3, 4, 6, 3], **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(Bottleneck, [3, 4, 23, 3], **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(Bottleneck, [3, 8, 36, 3], **kwargs)


create_model = resnet50

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "create_model"]
