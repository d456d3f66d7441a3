"""Misc helpers (counterpart of singa_tpu/utils.py, numpy only): the
progress bar, the SAME-padding arithmetic the ONNX backend uses, the odd
padding helpers, the tape's postorder walk, and `dense_allreduce_types`,
which reads a step's op listing where the JAX package's reads XLA's
lowered program."""

from __future__ import annotations

import sys

import numpy as np


def update_progress(progress: float, info: str):
    """Text progress bar (ref utils.py:27)."""
    length = 20
    progress = max(0.0, min(1.0, float(progress)))
    block = int(round(length * progress))
    bar = "#" * block + "-" * (length - block)
    sys.stdout.write(f"[{bar}] {progress * 100:3.1f}% {info}\r")
    sys.stdout.flush()


def force_unicode(s):
    """(ref utils.py:219)"""
    return s.decode() if isinstance(s, bytes) else str(s)


def get_padding_shape(pad_mode, input_spatial_shape, kernel_spatial_shape,
                      stride_spatial_shape):
    """Per-side pads for ONNX SAME_UPPER/SAME_LOWER (ref utils.py:159)."""
    pads = []
    for i, k, s in zip(input_spatial_shape, kernel_spatial_shape,
                       stride_spatial_shape):
        out = -(-i // s)
        total = max((out - 1) * s + k - i, 0)
        half = total // 2
        if pad_mode == "SAME_UPPER":
            pads.append((half, total - half))
        else:
            pads.append((total - half, half))
    return pads


def get_output_shape(auto_pad, input_spatial_shape, kernel_spatial_shape,
                     stride_spatial_shape):
    """(ref utils.py:189)"""
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        return [-(-i // s) for i, s in
                zip(input_spatial_shape, stride_spatial_shape)]
    return [(i - k) // s + 1 for i, k, s in
            zip(input_spatial_shape, kernel_spatial_shape,
                stride_spatial_shape)]


def accuracy(pred: np.ndarray, target: np.ndarray) -> float:
    """Top-1 accuracy of logits/probs vs int labels."""
    return float((np.argmax(pred, axis=1) == target).mean())


# ---- reference-name helper parity (python/singa/utils.py) ---------------
# The conv/pool layers handle odd/same padding internally (the geometry
# lives in layer._ConvGeometry), but the reference exposes these helpers
# publicly, so equivalents operate on Tensor/array values directly.

def handle_odd_pad_fwd(x, odd_padding, is_pool=False):
    """Apply (left2, right2, left3, right3) odd padding on axes 2/3 of an
    NCHW tensor (ref utils.py:56): zero-pad for conv, edge-replicate for
    pool."""
    from .tensor import Tensor, from_numpy
    arr = x.numpy() if isinstance(x, Tensor) else np.asarray(x)
    flags = [(2, True), (2, False), (3, True), (3, False)]
    for (axis, left), pad in zip(flags, odd_padding):
        if pad == 0:
            continue
        if is_pool:
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(0, pad) if left else \
                slice(arr.shape[axis] - pad, arr.shape[axis])
            piece = arr[tuple(sl)]
        else:
            shp = list(arr.shape)
            shp[axis] = pad
            piece = np.zeros(shp, arr.dtype)
        arr = np.concatenate([piece, arr] if left else [arr, piece],
                             axis=axis)
    return from_numpy(arr, device=x.device) if isinstance(x, Tensor) else arr


def handle_odd_pad_bwd(dx, odd_padding):
    """Strip the padding applied by handle_odd_pad_fwd from a backward
    tensor (ref utils.py:88)."""
    from .tensor import Tensor, from_numpy
    arr = dx.numpy() if isinstance(dx, Tensor) else np.asarray(dx)
    flags = [(2, True), (2, False), (3, True), (3, False)]
    for (axis, left), pad in zip(flags, odd_padding):
        if pad == 0:
            continue
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(pad, None) if left else \
            slice(0, arr.shape[axis] - pad)
        arr = arr[tuple(sl)]
    return from_numpy(arr, device=dx.device) if isinstance(dx, Tensor) \
        else arr


def same_pad_shape_check(handle, pad_mode, x):
    """Assert the handle's symmetric padding matches what SAME padding
    computes for this input; returns the full per-side pads
    (ref utils.py:110)."""
    kernel = getattr(handle, "kernel_size", getattr(handle, "kernel", None))
    if kernel is None:
        raise ValueError(
            "handle carries no kernel size; pass the Conv2d/Pooling2d "
            "layer or its .handle (set after initialize())")
    stride = handle.stride
    input_spatial = tuple(x.shape)[2:]
    pads = get_padding_shape(pad_mode, input_spatial, kernel, stride)
    expect = [(lo + hi) // 2 for (lo, hi) in pads]
    assert list(handle.padding) == expect, (
        f"For a same mode, the given padding {list(handle.padding)} is "
        f"wrong, the correct one should be {expect}.")
    return pads


def re_new_handle(handle, x, is_pool=False):
    """Reference re-creates cuDNN descriptors when the input shape changes
    (utils.py:132). The geometry here is shape-agnostic (torch picks its
    algorithms per shape), so the same handle is returned."""
    return handle


def post_order_recursive(root, root_t):
    """Postorder DFS over the autograd tape from `root` (ref utils.py:234).
    Returns a list of (op, output_tensor) pairs, leaves first; each op
    appears once (shared subgraphs are not re-walked) and the traversal is
    iterative, so deep tapes don't hit the recursion limit."""
    out, seen = [], set()
    stack = [(root, root_t, False)]
    while stack:
        op, y, expanded = stack.pop()
        if op is None or id(op) in seen:
            continue
        if expanded:
            seen.add(id(op))
            out.append((op, y))
            continue
        stack.append((op, y, True))
        for src_op, _, x, _ in reversed(op.src):
            stack.append((src_op, x, False))
    return out


def dense_allreduce_types(listing: str):
    """Operand types of every NON-SCALAR all-reduce in a step's op listing
    (`introspect.capture_hlo`'s `<key>_<sha>.ops.txt`, where a collective
    is a `c10d.allreduce_` line with its operands' types), the wire-level
    check behind the sparse strategy: its step may all-reduce scalars
    only (the loss's mean, the health counts), the dense one every
    parameter. The JAX package's finds them in HLO text
    (singa_tpu/utils.py)."""
    import re
    dense = []
    for mt in re.finditer(r"^c10d\.allreduce_\.\w+\((.*)\) -> ", listing,
                          re.M):
        for shape in re.findall(r"\w+\[[^\]]*\]", mt.group(1)):
            if not shape.endswith("[]"):
                dense.append(shape)
    return dense

