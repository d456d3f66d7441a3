"""Port parity of two of the zoo's deeper models (resnet18, AlexNet)
against the JAX package's: the checks and tolerances of
test_torch_zoo.py (`check_zoo_model`), in a file of their own so the
test runner can spread the JAX builds over its workers."""

import pytest

from test_torch_zoo import check_zoo_model


@pytest.mark.parametrize("name", ["alexnet", "resnet18"])
def test_deep_zoo_model_matches_jax(name):
    check_zoo_model(name)
