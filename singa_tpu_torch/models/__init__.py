"""Model zoo of the port (counterpart of singa_tpu/models): the GPT for
now; the convolutional models come with the training slice."""

from . import transformer  # noqa: F401

_REGISTRY = {
    "gpt": transformer.create_model,
}


def create_model(name: str, **kwargs):
    """Build a zoo model by name."""
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return fn(**kwargs)
