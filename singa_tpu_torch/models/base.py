"""Shared classifier base (counterpart of singa_tpu/models/base.py):
forward -> logits, the softmax cross-entropy loss, and the optimizer
step named by `dist_option`."""

from __future__ import annotations

from .. import layer, model


class Classifier(model.Model):
    """Subclass and define `forward(x) -> logits`."""

    def __init__(self, num_classes=10, name=None):
        super().__init__(name)
        self.num_classes = num_classes
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        """One step: logits, the loss, backward and the update. Only
        `dist_option="plain"` runs here: the distributed options
        ("half", "partialUpdate", "sparseTopK", "sparseThreshold") come
        with the distribution slice (DistOpt)."""
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        if dist_option != "plain":
            if dist_option in ("half", "partialUpdate", "sparseTopK",
                               "sparseThreshold"):
                raise NotImplementedError(
                    f"dist_option={dist_option!r} needs DistOpt, which "
                    "comes with the distribution slice")
            raise ValueError(f"unknown dist_option {dist_option!r}")
        self.optimizer(loss)
        return out, loss
