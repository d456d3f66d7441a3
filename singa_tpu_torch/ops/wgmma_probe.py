"""Check the wgmma building blocks of the tensor-core flash kernels
(`csrc/flash_tc.cuh`) against `torch.matmul` on the card, one 64 x N
product per operand flavour (`csrc/wgmma_probe.cu` lists them). A wrong
descriptor gives finite, plausible, wrong numbers; this shows it apart
from any attention arithmetic.

    python3 -m singa_tpu_torch.ops.wgmma_probe

prints each flavour's error and exits non-zero if one is off. Needs a
CUDA card. A diagnostic, not part of the model's path: its source is in
`_build.DIAGNOSTICS`, built on its first run and never by
`_build.build_all()`; `chip_smoke.py`'s phase 2 holds the flash kernels
themselves against their plain versions. Run it first after editing
`flash_tc.cuh`, where it tells a descriptor fault apart from the rest.
"""

from __future__ import annotations

import sys

import torch

from . import _build
from .attention import _entry, _stream

#: relative error allowed against an fp32 product of the same bf16 inputs:
#: the products are exact in fp32, only the summation order differs
TOL = 1e-4
#: mode -> (name, A's shape, B's shape, reference C from fp32 A and B)
MODES = {
    0: ("ss K-major n128 (K1's S = Q K^T)", (64, 128), (128, 128),
        lambda a, b: a @ b.T),
    1: ("ss K-major n64 (K2a's S^T, dP^T)", (64, 128), (64, 128),
        lambda a, b: a @ b.T),
    2: ("rs, B MN-major n128 (K1's P V)", (64, 128), (128, 128),
        lambda a, b: a @ b),
    3: ("rs, B MN-major n64 (K2a's dV, dK at D 64)", (64, 128), (128, 64),
        lambda a, b: a @ b),
    4: ("ss A and B MN-major n64, B's second column block (K2a's dQ)",
        (128, 64), (128, 128), lambda a, b: a.T @ b[:, 64:]),
}


def run(seed: int = 0) -> "dict[str, float]":
    """{flavour: max |C - ref| / max |ref|} over the probe's modes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    fn = _entry("wgmma_probe", "sg_wgmma_probe")
    errs = {}
    for mode, (name, sa, sb, ref_fn) in MODES.items():
        a, b = (torch.randn(s, generator=g, device="cuda")
                .to(torch.bfloat16) for s in (sa, sb))
        ref = ref_fn(a.float(), b.float())
        c = torch.empty(ref.shape, dtype=torch.float32, device="cuda")
        _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), mode,
                        _stream(a)), "wgmma_probe")
        torch.cuda.synchronize()
        errs[name] = float((c - ref).abs().max() / ref.abs().max())
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("wgmma_probe: no CUDA device", file=sys.stderr)
        return 1
    errs = run()
    for name, e in errs.items():
        print(f"  wgmma {name}: relative error {e:.3e} (tol {TOL}) "
              f"{'ok' if e <= TOL else 'FAIL'}")
    return 0 if all(e <= TOL for e in errs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
