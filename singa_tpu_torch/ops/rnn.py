"""The recurrences as tape operators (counterpart of singa_tpu/ops/rnn.py):
a multi-step LSTM (fixed and variable lengths), the per-sample time
reversal of a padded batch, and a GRU.

Each function takes raw tensors (and returns raw results, differentiable
by torch autograd) or `tensor.Tensor`s (one tape node, Tensors out), as
the port's other operators do. The JAX package runs each recurrence as
one `lax.scan`; here a Python loop over the time steps runs the same
cell, with x @ Wx hoisted out of the loop into one matmul over every
step (the sum keeps the JAX order, x_t Wx + h Wh + b). Variable lengths
stay a device tensor: the loop's masks read them on the device, so a
CUDA graph captures a step over them. cuDNN's fused LSTM is not used: it
has two biases, and no counterpart of frozen carries past a sample's
length or of GRU's `linear_before_reset=False`."""

from __future__ import annotations

import torch

from .. import initializer
from ..autograd import Operator
from ..tensor import Tensor


def init_lstm_params(in_size: int, hidden: int, device, dtype):
    """(Wx (in, 4H), Wh (H, 4H), b (4H,)) Tensors: glorot-uniform
    weights, zero bias with the forget gate's quarter at 1.0. Gate order
    i, f, g, o."""
    Wx = Tensor((in_size, 4 * hidden), device=device, dtype=dtype)
    initializer.glorot_uniform(Wx)
    Wh = Tensor((hidden, 4 * hidden), device=device, dtype=dtype)
    initializer.glorot_uniform(Wh)
    b = Tensor((4 * hidden,), device=device, dtype=dtype)
    b.set_value(0.0)
    b.data[hidden:2 * hidden] = 1.0
    return Wx, Wh, b


def _lstm_cell(z, c):
    """Gate pre-activations z (B, 4H) and carry c -> (h, c)."""
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _lstm(x, hx, cx, Wx, Wh, b, lengths=None):
    """x (T, B, F) -> (ys (T, B, H), hy, cy). With `lengths` (B,), steps
    at or past a sample's length freeze its carry and output zeros."""
    xw = x @ Wx
    h, c, ys = hx, cx, []
    for t in range(x.shape[0]):
        h2, c2 = _lstm_cell(xw[t] + h @ Wh + b, c)
        if lengths is None:
            h, c = h2, c2
            ys.append(h2)
            continue
        live = (t < lengths)[:, None]
        h = torch.where(live, h2, h)
        c = torch.where(live, c2, c)
        ys.append(torch.where(live, h2, torch.zeros_like(h2)))
    return torch.stack(ys), h, c


class _LSTMScan(Operator):
    """Multi-step LSTM as one tape node: (ys, hy, cy)."""

    def __init__(self, hidden: int):
        super().__init__("LSTMScan")
        self.hidden = hidden

    def forward(self, x, hx, cx, Wx, Wh, b):
        return _lstm(x, hx, cx, Wx, Wh, b)


def lstm_scan(x, hx, cx, Wx, Wh, b):
    """x (seq, batch, feature) -> (ys, hy, cy)."""
    return _LSTMScan(Wh.shape[0])(x, hx, cx, Wx, Wh, b)


class _LSTMScanEx(Operator):
    """Variable-length LSTM over a padded batch, the counterpart of
    cuDNN's packed-sequence calls: past a sample's length its (h, c)
    carry freezes and its outputs are zero, so hy and cy are the states
    at each sample's last step. Lengths are an integer input that
    carries no gradient."""

    def __init__(self, hidden: int):
        super().__init__("LSTMScanEx")
        self.hidden = hidden

    def forward(self, x, lengths, hx, cx, Wx, Wh, b):
        return _lstm(x, hx, cx, Wx, Wh, b, lengths)


def lstm_scan_ex(x, lengths, hx, cx, Wx, Wh, b):
    """Variable-length lstm_scan; lengths (batch,) int."""
    return _LSTMScanEx(Wh.shape[0])(x, lengths, hx, cx, Wx, Wh, b)


class _ReversePadded(Operator):
    """Reverse each sample's valid prefix along time, the padding left in
    place: the input of a bidirectional RNN's backward direction over a
    variable-length batch."""

    def forward(self, x, lengths):
        t = torch.arange(x.shape[0], device=x.device)[:, None]   # (T, 1)
        L = lengths.long()[None, :]
        idx = torch.where(t < L, L - 1 - t, t)                   # (T, B)
        return torch.gather(x, 0, idx[..., None].expand(x.shape))


def reverse_padded(x, lengths):
    return _ReversePadded()(x, lengths)


class _GRUScan(Operator):
    def __init__(self, hidden: int, linear_before_reset: bool = True):
        super().__init__("GRUScan")
        self.hidden = hidden
        self.lbr = bool(linear_before_reset)

    def forward(self, x, hx, Wx, Wh, b, rb=None):
        H, lbr = self.hidden, self.lbr
        zx_all = x @ Wx + b
        # without linear_before_reset the candidate's recurrent term is
        # recomputed from r*h, so only the r and u columns are needed
        Whg = Wh if lbr else Wh[:, :2 * H]
        h, ys = hx, []
        for t in range(x.shape[0]):
            zx = zx_all[t]
            zh = h @ Whg
            if rb is not None:
                zh = zh + (rb if lbr else rb[:2 * H])
            r = torch.sigmoid(zx[..., :H] + zh[..., :H])
            u = torch.sigmoid(zx[..., H:2 * H] + zh[..., H:2 * H])
            if lbr:
                # n = tanh(Wn x + Wbn + r * (Rn h + Rbn))
                n = torch.tanh(zx[..., 2 * H:] + r * zh[..., 2 * H:])
            else:
                # n = tanh(Wn x + Wbn + (r * h) Rn + Rbn)
                nr = (r * h) @ Wh[:, 2 * H:]
                if rb is not None:
                    nr = nr + rb[2 * H:]
                n = torch.tanh(zx[..., 2 * H:] + nr)
            h = (1 - u) * n + u * h
            ys.append(h)
        return torch.stack(ys), h


def gru_scan(x, hx, Wx, Wh, b, rb=None, linear_before_reset: bool = True):
    """GRU over x (seq, batch, feature) -> (ys, hy); gate order r, u, n.
    The optional `rb` is a separate recurrent bias (3H,). With
    `linear_before_reset` (torch's and Keras' reset_after form) it is
    added to h @ Wh inside the reset multiply; without it the reset gate
    multiplies h before the candidate's recurrent matmul (ONNX GRU,
    linear_before_reset=0)."""
    op = _GRUScan(Wh.shape[0], linear_before_reset)
    return op(x, hx, Wx, Wh, b, rb) if rb is not None \
        else op(x, hx, Wx, Wh, b)


__all__ = ["gru_scan", "init_lstm_params", "lstm_scan", "lstm_scan_ex",
           "reverse_padded"]
