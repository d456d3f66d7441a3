"""Port parity of the zoo's xceptionnet against the JAX package's: the
checks and tolerances of test_torch_zoo.py (`check_zoo_model`: one SGD
step, since Xception on a batch of two is chaotic past it), in a file of
its own so the test runner can spread the JAX builds over its workers."""

from test_torch_zoo import check_zoo_model


def test_xceptionnet_matches_jax():
    check_zoo_model("xceptionnet")
