"""Third-party interop helpers (counterpart of singa_tpu/sonnx/interop.py).

`export_torch_module` produces a genuine torch-exported .onnx without the
`onnx` pip package: the TorchScript exporter imports it only to inline
onnxscript functions, a no-op for plain modules, so that step is stubbed.
Used by the interop tests and chip_smoke.py's phase 11 (an independent
producer's file, made at run time instead of downloading a zoo file).
"""

from __future__ import annotations

import importlib
import os

#: where torch's releases keep the module with `_add_onnxscript_fn`
_PROTO_UTILS = ("torch.onnx._internal.torchscript_exporter.onnx_proto_utils",
                "torch.onnx._internal.onnx_proto_utils")


def _find_onnx_proto_utils():
    """The private module moved across torch releases: the first of
    `_PROTO_UTILS` that imports and has the hook; ImportError naming
    every path tried otherwise."""
    for path in _PROTO_UTILS:
        try:
            mod = importlib.import_module(path)
        except ImportError:
            continue
        if hasattr(mod, "_add_onnxscript_fn"):
            return mod
    import torch
    raise ImportError(f"torch {torch.__version__}: no module with "
                      f"_add_onnxscript_fn among {list(_PROTO_UTILS)}")


def export_torch_module(m, args, path, opset=13):
    """Export torch module `m` traced on `args` to ONNX at `path`."""
    import torch
    onnx_proto_utils = _find_onnx_proto_utils()
    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, _: model_bytes
    try:
        m.eval()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        torch.onnx.export(m, args, str(path), opset_version=opset,
                          dynamo=False)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig
    return path
