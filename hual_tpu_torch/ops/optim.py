"""BERT-style AdamW (counterpart of ``hual_tpu/ops/optim.py``).

The reference optimizer, as the JAX package runs it:

* global-norm clip first (optax's ``clip_by_global_norm``: scale by
  ``max_norm / g_norm`` only when ``g_norm >= max_norm``, no eps);
* ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g^2``, with NO bias
  correction;
* ``update = m / (sqrt(v) + eps) [+ wd * p on decayed leaves]``, eps 1e-6;
* ``p -= lr * update``, with the lr given per step: a Python float, or
  the optimizer's 0-dim f32 device buffer ``lr`` (:meth:`BertAdamW.set_lr`),
  which a captured CUDA graph reads at every replay.  Both multiply by the
  same f32 value, so the two give the same bits.

Weight decay skips every leaf whose JAX key contains ``layer_norm`` or
``bias``; the mask comes from the leaves' JAX keys (``weights._leaves``),
never from PyTorch's parameter names.  The whole step is PyTorch's
multi-tensor (``torch._foreach_*``) ops over the 170 leaves, and the clip
decides on the device, so a step never waits for the host.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def count_params(model: nn.Module) -> int:
    """Total trainable parameter count."""
    return sum(p.numel() for p in model.parameters())


def decayed(key: str) -> bool:
    """True where weight decay applies: the key has no layer_norm / bias part."""
    full = key.lower()
    return "layer_norm" not in full and "bias" not in full


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """JAX key -> whether weight decay applies, for every leaf of ``model``."""
    from hual_tpu_torch.weights import _leaves

    return {key: decayed(key) for key, *_ in _leaves(model)}


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> tuple[list[torch.Tensor], torch.Tensor]:
    """optax's clip: ``g / g_norm * max_norm`` when ``g_norm >= max_norm``,
    else ``g`` unchanged.  Returns (clipped grads, g_norm)."""
    norms = torch._foreach_norm(list(grads))
    g_norm = torch.linalg.vector_norm(torch.stack(norms))
    trigger = g_norm < max_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    # g / 1 * 1 is g itself: below the threshold the grads pass bit-exact
    divisor = torch.where(trigger, one, g_norm)
    factor = torch.where(trigger, one, torch.full_like(one, max_norm))
    clipped = torch._foreach_div(list(grads), divisor)
    torch._foreach_mul_(clipped, factor)
    return clipped, g_norm


class BertAdamW:
    """clip -> BERT-AdamW -> scale by the step's lr, over ``params`` in place.

    ``keys`` are the leaves' JAX keys (for the decay mask and the state's
    names); ``mu`` and ``nu`` hold one f32 tensor per leaf.
    """

    def __init__(self, params: Sequence[nn.Parameter], keys: Sequence[str],
                 clip_norm: float = 1.0, weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6):
        if len(params) != len(keys):
            raise ValueError(f"{len(params)} params for {len(keys)} keys")
        self.params = list(params)
        self.keys = list(keys)
        self.clip_norm, self.weight_decay = clip_norm, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self._decay = [i for i, k in enumerate(self.keys) if decayed(k)]
        with torch.no_grad():           # zero moments, as the reference starts
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        self.lr = torch.zeros((), dtype=torch.float32,
                              device=self.params[0].device if self.params else None)

    @torch.no_grad()
    def set_lr(self, lr: float) -> None:
        """Write ``lr`` into the device buffer ``self.lr`` (a fill on the
        device: no host copy, no synchronisation)."""
        self.lr.fill_(lr)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             lr: float | torch.Tensor) -> torch.Tensor:
        """Apply one update from ``grads`` (aligned with ``params``) at rate
        ``lr`` (a float, or ``self.lr``); returns the global grad norm before
        the clip, on the device."""
        grads, g_norm = clip_by_global_norm(grads, self.clip_norm)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(self.mu, denom)
        if self.weight_decay and self._decay:
            torch._foreach_add_([updates[i] for i in self._decay],
                                [self.params[i] for i in self._decay],
                                alpha=self.weight_decay)
        torch._foreach_mul_(updates, lr)
        torch._foreach_sub_(self.params, updates)
        return g_norm

    def state_dict(self) -> dict[str, dict[str, torch.Tensor]]:
        return {"mu": dict(zip(self.keys, self.mu)),
                "nu": dict(zip(self.keys, self.nu))}

    def load_state_dict(self, state: dict[str, dict[str, torch.Tensor]]) -> None:
        for name in ("mu", "nu"):
            missing = set(self.keys) ^ set(state[name])
            if missing:
                raise ValueError(f"optimizer state {name} differs in leaves "
                                 f"{sorted(missing)}")
        with torch.no_grad():
            for name in ("mu", "nu"):
                for dst, key in zip(getattr(self, name), self.keys):
                    dst.copy_(state[name][key])


def make_optimizer(model: nn.Module, clip_norm: float = 1.0,
                   weight_decay: float = 0.01) -> BertAdamW:
    """The reference optimizer over every leaf of ``model``, in the leaf
    order of ``weights._leaves``."""
    from hual_tpu_torch.weights import _leaves

    leaves = list(_leaves(model))
    return BertAdamW([p for _, p, *_ in leaves], [k for k, *_ in leaves],
                     clip_norm=clip_norm, weight_decay=weight_decay)
