"""sonnx: ONNX import and export (counterpart of singa_tpu/sonnx/).

- `prepare(model_proto, device)` -> SingaRep with .run(inputs)  (import)
- `export(model, inputs, path)` / `to_onnx_model(...)`          (export)
- `SONNXModel` wraps an imported graph as a trainable Model      (retrain)
- `load_model/save_model` on the self-contained protobuf codec (onnx_pb)

The device defaults to the card; pass `device.create_cpu_device()` (or a
Device) to import on the CPU.
"""

from __future__ import annotations

import numpy as np

from .. import model as model_module
from . import onnx_pb
from .onnx_pb import load_model, save_model  # noqa: F401
from .backend import OnnxNode, SingaBackend, SingaRep, prepare  # noqa: F401
from .frontend import to_onnx_model, export  # noqa: F401
from . import frontend as _frontend_module


def _attr_name(prefix, name):
    return prefix + name.replace(".", "_").replace("/", "_") \
        .replace(":", "_")


class SONNXModel(model_module.Model):
    """Re-trainable wrapper over an imported ONNX graph
    (ref sonnx.py:2196). Subclass and define train_one_batch; forward
    returns the graph outputs (a single Tensor if there is exactly one).

    The imported weights are this Model's `nn.Parameter`s, `onnx__<name>`,
    and the running statistics its buffers, `onnxs__<name>` (the JAX
    package's names), so compile, the optimizers, get_states, checkpoints
    and the CUDA-graph step (`compile(use_graph=True)`) see them."""

    def __init__(self, onnx_model: "onnx_pb.ModelProto", device=None,
                 name=None):
        super().__init__(name)
        self.backend = SingaBackend(onnx_model, device)
        for pname, t in self.backend.params.items():
            self.register_parameter(_attr_name("onnx__", pname), t.data)
        for sname, t in self.backend.states.items():
            self.register_buffer(_attr_name("onnxs__", sname), t.data)

    def forward(self, *x, last_layers=None):
        """last_layers: stop after that many graph nodes (negative counts
        from the end) and return that node's outputs — the reference's
        truncated-backbone retraining hook (ref sonnx.py:2212)."""
        outs = self.backend.run(list(x), last_layers=last_layers)
        return outs[0] if len(outs) == 1 else outs


class SingaFrontend:
    """Exporter entry points as classmethods, matching the reference's
    class-of-staticmethods surface (sonnx.py:75/886-968); each delegates
    to the functional exporter in frontend.py."""

    @classmethod
    def singa_to_onnx_model(cls, inputs, y, model_name="sonnx"):
        return _frontend_module.to_onnx_model(inputs, y,
                                              model_name=model_name)

    @classmethod
    def singa_to_onnx_graph(cls, inputs, y, model_name="sonnx"):
        return cls.singa_to_onnx_model(inputs, y, model_name).graph

    @classmethod
    def handle_special_ops(cls, op, X, W):
        raise NotImplementedError(
            "special-op rewriting happens inside to_onnx_model here "
            "(frontend.py); this hook is internal to the reference's "
            "exporter and has no standalone equivalent")

    @classmethod
    def singa_op_to_onnx_node(cls, op, op_t):
        """Export ONE traced op: the NodeProto list the exporter emits for
        exactly this op, its inputs named from the tape edges
        (ref sonnx.py:886)."""
        del op_t  # the op carries its own outputs
        f = _frontend_module
        ctx = f._Ctx(None)
        # name upstream producers' outputs without walking their
        # subgraphs, and register Dummy leaves as graph INPUTS (cheap
        # ValueInfo) rather than serialized initializers
        input_ids = {}
        for i, (src_op, x_id, _x, _s) in enumerate(op.src):
            if isinstance(src_op, f.autograd.Dummy):
                input_ids[x_id] = i
            else:
                key = (src_op, src_op.y_id2idx[x_id])
                ctx.names.setdefault(key, ctx.fresh(f"in{i}"))
        outs = f._out_names(ctx, op)
        ins = [f._input_name(ctx, op, i, input_ids)
               for i in range(len(op.src))]
        return list(f._emit(ctx, op, ins, outs))


class OnnxAttributes(dict):
    """Plain-dict view of a node's ONNX attributes (ref sonnx.py:1023)."""

    @staticmethod
    def from_onnx(args):
        d = OnnxAttributes()
        for arg in args:
            d[arg.name] = arg.value()  # AttributeProto.value
        return d


def onnx_type_to_singa_type(onnx_type):
    """ONNX TensorProto dtype enum -> framework dtype name
    (ref sonnx.py:64)."""
    np_dtype = onnx_pb._ONNX2NP.get(onnx_type)
    return str(np.dtype(np_dtype)) if np_dtype is not None else None
