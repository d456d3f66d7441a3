"""Port parity, files from an independent producer: the modules of
tests/test_onnx_torch.py (a CNN with batch norm and a grouped conv, a
ConvTranspose + InstanceNorm + HardSwish generator, a transformer block,
an LSTM with a head, an MLP) exported by torch's TorchScript exporter
through `singa_tpu_torch.sonnx.interop.export_torch_module`, imported by
both packages. Each import matches torch's own forward (rtol 1e-3, atol
1e-4, as the JAX tests hold theirs) and the two imports agree (rtol
1e-5, atol 1e-5). The imported MLP retrains under SGD in the port as in
the JAX package."""

import numpy as np
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jt
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.sonnx.interop import export_torch_module

torch.set_num_threads(2)


def _import_both(path, x_np):
    out = {}
    for pkg, sonnx, ag, tm, dev in (
            ("jax", jsonnx, jag, jt, jdevice.best_device()),
            ("port", tsonnx, tag, tt, tdevice.create_cpu_device())):
        rep = sonnx.prepare(sonnx.load_model(str(path)), dev)
        prev = ag.training
        ag.training = False
        try:
            out[pkg] = rep.run([tm.from_numpy(x_np, device=dev)])[0].numpy()
        finally:
            ag.training = prev
    return out


def _check(m, x, path, opset=13):
    export_torch_module(m, x, str(path), opset=opset)
    with torch.no_grad():
        ref = m(x).numpy()
    got = _import_both(path, x.numpy())
    np.testing.assert_allclose(got["port"], ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-5,
                               atol=1e-5)


def test_torch_cnn_import_parity(tmp_path):
    torch.manual_seed(0)
    m = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, stride=2, padding=1),
        torch.nn.BatchNorm2d(8),
        torch.nn.ReLU(),
        torch.nn.MaxPool2d(2),
        torch.nn.Conv2d(8, 16, 3, padding=1, groups=2),
        torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1),
        torch.nn.Flatten(),
        torch.nn.Linear(16, 10),
    )
    _check(m, torch.randn(2, 3, 32, 32), tmp_path / "cnn.onnx")


def test_torch_deconv_instancenorm_import_parity(tmp_path):
    torch.manual_seed(1)

    class G(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = torch.nn.ConvTranspose2d(4, 8, 4, stride=2, padding=1)
            self.inorm = torch.nn.InstanceNorm2d(8, affine=True)
            self.act = torch.nn.Hardswish()
            self.out = torch.nn.Conv2d(8, 3, 3, padding=1)

        def forward(self, x):
            return torch.tanh(self.out(self.act(self.inorm(self.up(x)))))

    _check(G(), torch.randn(2, 4, 8, 8), tmp_path / "gen.onnx")


def test_torch_transformer_block_import_parity(tmp_path):
    torch.manual_seed(2)

    class Block(torch.nn.Module):
        def __init__(self, d=16, h=4):
            super().__init__()
            self.ln1 = torch.nn.LayerNorm(d)
            self.qkv = torch.nn.Linear(d, 3 * d)
            self.proj = torch.nn.Linear(d, d)
            self.ln2 = torch.nn.LayerNorm(d)
            self.ff1 = torch.nn.Linear(d, 4 * d)
            self.ff2 = torch.nn.Linear(4 * d, d)
            self.h = h

        def forward(self, x):
            B, S, D = x.shape
            q, k, v = self.qkv(self.ln1(x)).chunk(3, -1)

            def split(t):
                return t.reshape(B, S, self.h, D // self.h).transpose(1, 2)

            q, k, v = split(q), split(k), split(v)
            a = torch.softmax(q @ k.transpose(-1, -2)
                              / (D // self.h) ** 0.5, -1)
            o = (a @ v).transpose(1, 2).reshape(B, S, D)
            x = x + self.proj(o)
            return x + self.ff2(torch.nn.functional.gelu(self.ff1(
                self.ln2(x))))

    _check(Block(), torch.randn(2, 6, 16), tmp_path / "block.onnx", opset=14)


def test_torch_lstm_import_parity(tmp_path):
    torch.manual_seed(3)

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = torch.nn.LSTM(6, 8)
            self.head = torch.nn.Linear(8, 4)

        def forward(self, x):
            y, _ = self.lstm(x)
            return self.head(y[-1])

    _check(M(), torch.randn(5, 2, 6), tmp_path / "lstm.onnx")


def test_torch_imported_model_retrains(tmp_path):
    """The imported graph's initializers are tape parameters: SGD through
    autograd.backward lowers the loss, step for step as in the JAX
    package (losses within rtol 1e-4)."""
    torch.manual_seed(4)
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 3))
    x = torch.randn(16, 8).numpy()
    export_torch_module(m, torch.from_numpy(x), str(tmp_path / "mlp.onnx"))
    y = np.random.RandomState(0).randint(0, 3, 16).astype(np.int32)
    cpu = tdevice.create_cpu_device()
    rep = tsonnx.prepare(tsonnx.load_model(str(tmp_path / "mlp.onnx")), cpu)
    sgd = topt.SGD(lr=0.5)
    losses = []
    prev = tag.training
    tag.training = True
    try:
        for _ in range(15):
            out = rep.run([tt.from_numpy(x, device=cpu)])[0]
            loss = tag.softmax_cross_entropy(out, tt.from_numpy(y,
                                                                device=cpu))
            for p, g in tag.backward(loss):
                # the port's apply takes the raw tensors (as
                # backward_and_update hands them over)
                sgd.apply(tt._raw(p), tt._raw(g))
            losses.append(float(loss.numpy()))
            sgd.step()
    finally:
        tag.training = prev
    assert losses[-1] < losses[0] * 0.8, losses

    from singa_tpu import opt as jopt
    jdev = jdevice.best_device()
    jrep = jsonnx.prepare(jsonnx.load_model(str(tmp_path / "mlp.onnx")),
                          jdev)
    jsgd = jopt.SGD(lr=0.5)
    jlosses = []
    prev = jag.training
    jag.training = True
    try:
        for _ in range(15):
            out = jrep.run([jt.from_numpy(x, device=jdev)])[0]
            loss = jag.softmax_cross_entropy(out, jt.from_numpy(y,
                                                                device=jdev))
            for p, g in jag.backward(loss):
                jsgd.apply(p, g)
            jlosses.append(float(loss.numpy()))
            jsgd.step()
    finally:
        jag.training = prev
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
