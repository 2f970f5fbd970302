"""Weight bridge: the JAX package's SeqPAN parameters <-> the port's SeqPAN.

The exchange format is the flat path-keyed numpy dict of a serving bundle's
``params.npz`` (``hual_tpu/serve.py::_flatten_params``), with keys such as
``params/d_attn_0/dual_multihead_attention/query/kernel``.  The port's
modules carry the JAX scope names, so a leaf's key is ``params/`` + the
module path + the JAX leaf name; only the layouts move:

==========================  ==================  =====================
leaf                        JAX shape           port shape
==========================  ==================  =====================
dense ``kernel``            (1, in, out)        (out, in)
dense ``bias``              (1, 1, out)         (out,)
LayerNorm ``scale``         (D,)                ``weight`` (D,)
``depthwise_filter``        (k, 1, D, 1)        (D, 1, k)
``pointwise_filter``        (1, 1, D, D)        (out, in)
char ``filter_i`` (HWIO)    (1, k, dim, ch)     (ch, dim, k)
trilinear ``arg0/arg1``     (d, 1)              (d,)
trilinear ``mul``           (1, 1, d)           (d,)
pooling ``weight``          (d, 1)              (d,)
==========================  ==================  =====================

Every other leaf keeps its shape.  Both directions are exact copies and
transposes, so a round trip is bit-exact; loading raises on an unknown, a
missing or a wrong-shape leaf, as ``hual_tpu.serve`` does.
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from hual_tpu_torch.models.layers import (Bilinear, Conv1D,
                                          DepthwiseSeparableConv, LayerNorm,
                                          TrilinearAttention, WeightedPooling)
from hual_tpu_torch.models.modules import (CharEmbedding, PositionalEmbedding,
                                           WordEmbedding)
from hual_tpu_torch.models.seqpan import SeqPAN

Move = Callable[[np.ndarray], np.ndarray]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _leaf_specs(module: nn.Module) -> list[tuple[str, str, Move, Move]]:
    """(JAX leaf name, port parameter name, to_port, to_jax) per leaf the
    module owns directly."""
    vec_col = (lambda a: a[:, 0], lambda w: w[:, None])
    if isinstance(module, LayerNorm):
        return [("scale", "weight", _same, _same),
                ("bias", "bias", _same, _same)]
    if isinstance(module, Conv1D):
        specs = [("kernel", "weight", lambda a: a[0].T, lambda w: w.T[None])]
        if module.bias is not None:
            specs.append(("bias", "bias", lambda a: a.reshape(-1),
                          lambda w: w[None, None]))
        return specs
    if isinstance(module, DepthwiseSeparableConv):
        return [("depthwise_filter", "depthwise_filter",
                 lambda a: a[:, 0, :, 0].T[:, None, :],
                 lambda w: w[:, 0, :].T[:, None, :, None]),
                ("pointwise_filter", "pointwise_filter",
                 lambda a: a[0, 0].T, lambda w: w.T[None, None]),
                ("bias", "bias", _same, _same)]
    if isinstance(module, Bilinear):
        return [("bias", "bias", _same, _same)]
    if isinstance(module, TrilinearAttention):
        return [("linear_kernel4arg0", "linear_kernel4arg0", *vec_col),
                ("linear_kernel4arg1", "linear_kernel4arg1", *vec_col),
                ("linear_kernel4mul", "linear_kernel4mul",
                 lambda a: a[0, 0], lambda w: w[None, None])]
    if isinstance(module, WeightedPooling):
        return [("weight", "weight", *vec_col)]
    if isinstance(module, CharEmbedding):
        specs = [("char_table", "char_table", _same, _same)]
        for i in range(len(module.kernels)):
            specs += [(f"filter_{i}", f"filter_{i}",
                       lambda a: a[0].transpose(2, 1, 0),
                       lambda w: w.transpose(2, 1, 0)[None]),
                      (f"bias_{i}", f"bias_{i}", _same, _same)]
        return specs
    if isinstance(module, PositionalEmbedding):
        return [("position_embeddings", "position_embeddings", _same, _same)]
    if isinstance(module, WordEmbedding):
        return [("unk", "unk", _same, _same)]
    if isinstance(module, SeqPAN):
        return [("label_emb", "label_emb", _same, _same)]
    return []


def _leaves(model: SeqPAN) -> Iterator[tuple[str, nn.Parameter, Move, Move]]:
    """(JAX key, parameter, to_port, to_jax) for every leaf of ``model``;
    raises if a parameter has no JAX leaf."""
    covered = set()
    for path, module in model.named_modules():
        prefix = "/".join(["params", *path.split(".")]) if path else "params"
        for leaf, name, to_port, to_jax in _leaf_specs(module):
            param = getattr(module, name)
            covered.add(id(param))
            yield f"{prefix}/{leaf}", param, to_port, to_jax
    stray = [n for n, p in model.named_parameters() if id(p) not in covered]
    if stray:
        raise ValueError(f"parameters without a JAX leaf: {stray}")


def to_jax_params(model: SeqPAN) -> dict[str, np.ndarray]:
    """The port's weights as the JAX package's flat ``params.npz`` dict: a
    copy, never a view of a CPU parameter (a later update must not move a
    snapshot)."""
    return {key: np.array(to_jax(p.detach().cpu().numpy()), order="C", copy=True)
            for key, p, _, to_jax in _leaves(model)}


def load_jax_params(model: SeqPAN, flat: Mapping[str, np.ndarray]) -> SeqPAN:
    """Copy the JAX package's flat parameter dict into ``model``, in place.

    Raises ValueError on a missing, unknown or wrong-shape leaf.
    """
    leaves = list(_leaves(model))
    extra = set(flat) - {key for key, *_ in leaves}
    if extra:
        raise ValueError(f"params have unknown leaves {sorted(extra)}")
    with torch.no_grad():
        for key, param, to_port, to_jax in leaves:
            if key not in flat:
                raise ValueError(f"params are missing leaf {key!r}")
            value = np.asarray(flat[key], np.float32)
            expected = to_jax(np.empty(tuple(param.shape), np.float32)).shape
            if value.shape != expected:
                raise ValueError(f"leaf {key!r} has shape {value.shape}, "
                                 f"model expects {expected}")
            param.copy_(torch.from_numpy(np.array(to_port(value))))
    return model
