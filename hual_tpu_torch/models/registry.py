"""Model registry (counterpart of ``hual_tpu/models/registry.py``): configs
name a model by string, and the name resolves here, never through eval."""

from __future__ import annotations

from hual_tpu_torch.models.seqpan import SeqPAN

_REGISTRY: dict[str, type] = {"SeqPAN": SeqPAN}


def get_model_class(name: str) -> type:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
