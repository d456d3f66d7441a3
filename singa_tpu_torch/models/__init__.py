"""Model zoo of the port (counterpart of singa_tpu/models): every model
is a `model.Model`; `create_model` takes the JAX package's names, the
pipelined GPT (`transformer.PipelinedGPT`) among them as "gpt_pipe"."""

from .base import Classifier  # noqa: F401
from . import alexnet, cnn, mlp, resnet, transformer, xceptionnet  # noqa: F401
from .transformer import load_gpt2_weights  # noqa: F401

_REGISTRY = {
    "mlp": mlp.create_model,
    "cnn": cnn.create_model,
    "alexnet": alexnet.create_model,
    "resnet": resnet.resnet50,
    "resnet18": resnet.resnet18,
    "resnet34": resnet.resnet34,
    "resnet50": resnet.resnet50,
    "resnet101": resnet.resnet101,
    "resnet152": resnet.resnet152,
    "xceptionnet": xceptionnet.create_model,
    "gpt": transformer.create_model,
    "gpt_pipe": transformer.create_pipelined,
}


def create_model(name: str, **kwargs):
    """Build a zoo model by name."""
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return fn(**kwargs)
