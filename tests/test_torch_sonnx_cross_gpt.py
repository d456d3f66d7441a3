"""Port parity, ONNX files crossing the packages: the GPT, with learned
positions and with RoPE, exported by both packages from the same weights
(`load_singa_params`) and run by both, with the harness and tolerances of
test_torch_sonnx_cross.py; and the port's GPT file decoded by protoc."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from singa_tpu import models as jmodels
from singa_tpu import tensor as jt
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.models import transformer as ttr
from test_torch_sonnx_cross import CPU, _cross, _pkg, _tensors


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_gpt_crosses(pos, tmp_path):
    """The GPT traced on the tape: the fused attention decomposed to
    MatMul/Softmax (+ baked causal mask), tanh-GELU, LayerNormalization,
    the ids a real int32 graph input; RoPE as baked cos/sin tables."""
    cfg = dict(vocab_size=50, max_seq=16, dim=32, num_heads=4, num_layers=2,
               pos_encoding=pos)
    ids = np.random.RandomState(5).randint(0, 50, (2, 16)).astype(np.int32)
    jm = jmodels.create_model("gpt", **cfg)
    jm.compile(_tensors(_pkg("jax"), [ids]), is_train=False,
               use_graph=False)
    tm_ = ttr.GPT(**cfg, device="cpu", seed=3)
    ttr.load_singa_params(tm_, {k: jt.to_numpy(v)
                                for k, v in jm.get_params().items()})
    protos = _cross({"jax": jm, "port": tm_}, [ids], tmp_path)
    ops = {n.op_type for n in protos["port"].graph.node}
    assert {"MatMul", "Softmax", "Tanh", "LayerNormalization",
            "Gather"} <= ops, ops
    assert len(protos["port"].graph.input) == 1
    assert protos["port"].graph.input[0].type.tensor_type.elem_type \
        == tsonnx.onnx_pb.TensorProto.INT32
    if pos == "rope":
        assert {"Neg", "Concat"} <= ops


def test_export_bytes_parse_with_protoc(tmp_path):
    """The port's GPT file decoded by Google's protoc against a
    transcription of the public onnx.proto (tests/onnx_min.proto), a
    parser sharing no code with the codec."""
    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("protoc not installed")
    ids = np.random.RandomState(0).randint(0, 50, (2, 16)).astype(np.int32)
    m = ttr.GPT(vocab_size=50, max_seq=16, dim=32, num_heads=4,
                num_layers=2, device="cpu")
    proto = tsonnx.export(m, [tt.from_numpy(ids, device=CPU)],
                          str(tmp_path / "gpt.onnx"))
    here = os.path.dirname(os.path.abspath(__file__))
    with open(tmp_path / "gpt.onnx", "rb") as f:
        r = subprocess.run(
            [protoc, f"--proto_path={here}", "--decode=onnx.ModelProto",
             "onnx_min.proto"],
            stdin=f, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, f"protoc rejected the bytes: {r.stderr}"
    text = r.stdout
    assert text.count("op_type:") == len(proto.graph.node)
    assert 'producer_name: "singa_tpu_torch"' in text
    assert text.count("initializer {") == len(proto.graph.initializer)
    assert "LayerNormalization" in text
