"""Port parity, the operators only ONNX reaches, second half: UpSample,
DepthToSpace, SpaceToDepth, ScatterElements, Rope, TopK, CumSum, LRN,
the normalizations, ConvTranspose2d, GlobalMaxPool and Einsum against
`singa_tpu.autograd`, forward and gradient, with the harness and
tolerances of test_torch_sonnx_ops.py (a second file so that xdist's
loadfile keeps each under a minute)."""

import pytest

from test_torch_sonnx_ops import S4, X34, check_case

CASES = {
    "upsample": (lambda g, a: g.upsample(a, "nearest", [1, 1, 2, 3]),
                 [("f", (2, 3, 4, 4))]),
    "depth_to_space_dcr": (lambda g, a: g.depth_to_space(a, 2),
                           [("f", (2, 8, 3, 3))]),
    "depth_to_space_crd": (lambda g, a: g.depth_to_space(a, 2, "CRD"),
                           [("f", (2, 8, 3, 3))]),
    "space_to_depth": (lambda g, a: g.space_to_depth(a, 2),
                       [("f", (2, 2, 4, 6))]),
    "scatter_elements": (lambda g, a, u, idx: g.scatter_elements(
        a, idx, u, 0), [("f", (4, 3)), ("f", (2, 3)), ("k", (4, 2, 3))]),
    "rope": (lambda g, a: g.Rope()(a), [("f", (2, 2, 8, 16))]),
    "rope_theta": (lambda g, a: g.Rope(500.0)(a), [("f", (1, 3, 5, 8))]),
    "cumsum": (lambda g, a: g.cumsum(a, axis=1), [("f", (3, 4))]),
    "cumsum_reverse": (lambda g, a: g.cumsum(a, axis=0, reverse=1),
                       [("f", (3, 4))]),
    "topk": (lambda g, a: g.topk(a, k=2), [("f", (3, 5))]),
    "topk_smallest_axis0": (lambda g, a: g.TopK(2, 0, False)(a),
                            [("f", (4, 3))]),
    "topk_ties": (lambda g, a: g.TopK(3)(a), [("t", (6, 5))]),
    "lrn": (lambda g, a: g.lrn(a, size=3, alpha=1e-3), [("f", S4)]),
    "lrn_even": (lambda g, a: g.LRN(4, 0.3, 0.75, 1.0)(a),
                 [("f", (1, 6, 2, 2))]),
    "mean_variance_normalization": (
        lambda g, a: g.MeanVarianceNormalization()(a), [("f", S4)]),
    "lp_normalization_1": (lambda g, a: g.LpNormalization(1, 1)(a), X34),
    "lp_normalization_2": (lambda g, a: g.LpNormalization(-1, 2)(a), X34),
    "instance_norm": (lambda g, x, s, b: g.instance_norm(x, s, b),
                      [("f", S4), ("p", (3,)), ("f", (3,))]),
    "conv_transpose": (lambda g, x, w, b: g.conv_transpose2d(
        x, w, b, stride=(2, 2), padding=(1, 1), output_padding=(1, 1)),
        [("f", (2, 3, 5, 5)), ("f", (3, 4, 3, 3)), ("f", (4,))]),
    "conv_transpose_plain": (lambda g, x, w: g.conv_transpose2d(x, w),
                             [("f", (2, 3, 4, 4)), ("f", (3, 2, 2, 3))]),
    "conv_transpose_grouped": (lambda g, x, w: g.conv_transpose2d(
        x, w, stride=(2, 2), padding=(1, 1), group=2),
        [("f", (1, 4, 5, 5)), ("f", (4, 2, 3, 3))]),
    "conv_transpose_dilated": (lambda g, x, w, b: g.conv_transpose2d(
        x, w, b, stride=(1, 2), padding=(2, 1), dilation=(2, 1)),
        [("f", (2, 2, 6, 5)), ("f", (2, 3, 3, 3)), ("f", (3,))]),
    "global_max_pool": (lambda g, a: g.global_max_pool(a), [("f", S4)]),
    "einsum_matmul": (lambda g, a, b: g.einsum(a, b, equation="ij,jk->ik"),
                      [("f", (3, 4)), ("f", (4, 5))]),
    "einsum_permute": (lambda g, a: g.einsum(a, equation="nchw->nhwc"),
                       [("f", S4)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_matches_jax(name):
    check_case(CASES, name)
