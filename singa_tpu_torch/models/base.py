"""Shared classifier base (counterpart of singa_tpu/models/base.py):
forward -> logits, the softmax cross-entropy loss, and the optimizer
step named by `dist_option` (the reference's example models repeat this
dispatch, e.g. examples/cnn/model/cnn.py:53-71)."""

from __future__ import annotations

from .. import layer, model


class Classifier(model.Model):
    """Subclass and define `forward(x) -> logits`."""

    def __init__(self, num_classes=10, name=None):
        super().__init__(name)
        self.num_classes = num_classes
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        """One step: logits, the loss, backward and the update by
        `dist_option`: "plain" (the optimizer's call), and with a DistOpt
        "half", "partialUpdate", "sparseTopK" or "sparseThreshold"
        (`spars` defaults to 0.05)."""
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        opt = self.optimizer
        if dist_option == "plain":
            opt(loss)
        elif dist_option == "half":
            opt.backward_and_update_half(loss)
        elif dist_option == "partialUpdate":
            opt.backward_and_partial_update(loss)
        elif dist_option == "sparseTopK":
            opt.backward_and_sparse_update(loss, topK=True,
                                           spars=spars if spars else 0.05)
        elif dist_option == "sparseThreshold":
            opt.backward_and_sparse_update(loss, topK=False,
                                           spars=spars if spars else 0.05)
        else:
            raise ValueError(f"unknown dist_option {dist_option!r}")
        return out, loss
