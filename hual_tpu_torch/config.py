"""Structured configuration (counterpart of ``hual_tpu/config.py``).

The same dataclass schema, defaults and validation as the JAX package, so
``configs/*/SeqPAN.yaml`` and a serving bundle's ``meta.json`` load unchanged
in either package.  What the backend switches mean in this port:

* ``model.span_decode``: ``"xla"`` runs the plain PyTorch decode
  (``ops/decode.py``); ``"pallas"`` runs the hand-written Hopper kernel
  (``ops/kernels/span_decode.py``), which takes the plain decode only for
  tensors on the CPU.
* ``train.sweep_backend`` (the eval and AL-inference sweeps of
  ``runtime/trainer.py``): ``"flax"`` runs the port's eager SeqPAN;
  ``"fused"`` runs ``encoder_inputs``, then K2 (the fused forward,
  ``ops/kernels/fused_forward.py``), then K1, whatever
  ``model.span_decode`` says, as the JAX package's fused sweeps do.
  ``train.fused_block`` is the TPU kernel's block of samples and is not
  read: K2 takes one sample per thread block and any B.
* ``model.matmul_precision``: every value runs full fp32 on the card, with
  TF32 off for cuBLAS and cuDNN alike, and bf16 products summed in f32
  (:func:`apply_matmul_precision`).
* ``model.compute_dtype``: the activation dtype of the eager model,
  ``"float32"`` or ``"bfloat16"``, threaded as the JAX package threads it
  (``models/``): parameters stay f32 and are cast at each use, products sum
  in f32, LayerNorm statistics, softmaxes, losses and logits are f32.  The
  fused sweeps' input front stays f32 whatever it says; K2's products take
  bf16 operands under ``train.fused_mxu_bf16`` only.
* ``train.mc_dtype``: the activation dtype of the stochastic MC passes (a
  view of the model at that dtype, sharing its parameters); the clean pass
  runs at ``model.compute_dtype``.
* ``train.rng_impl`` and ``train.infer_rng_impl`` (the TPU's random-bit
  generators) are accepted and not read: the port's train and MC streams
  are ``torch.Generator``s seeded per step and per batch
  (``runtime/steps.make_generator``), Philox on the card whatever these
  name.  They never give the JAX package's bits, so parity of dropout and
  gumbel passes is distributional.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from hual_tpu_torch.utils.io import load_yaml

_DTYPE_ALIASES = {"float32": "float32", "f32": "float32", "": "float32",
                  "bfloat16": "bfloat16", "bf16": "bfloat16"}
_STORAGE_DTYPE_ALIASES = dict(_DTYPE_ALIASES, int8="int8", i8="int8")

# model.matmul_precision -> torch.set_float32_matmul_precision.  On the TPU
# "default" means one bf16 pass; this slice pins every value to full fp32 so
# the served logits stay within the parity bounds of the JAX reference.
TORCH_MATMUL_PRECISION = {"default": "highest", "high": "highest",
                          "highest": "highest"}


def _canon_dtype(name: Any, field_name: str, storage: bool = False) -> str:
    aliases = _STORAGE_DTYPE_ALIASES if storage else _DTYPE_ALIASES
    try:
        return aliases[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"{field_name} must be one of {sorted(set(aliases))!r}, "
            f"got {name!r}") from None


def _check_choice(value: Any, field_name: str, choices: tuple) -> Any:
    if value not in choices:
        raise ValueError(f"{field_name} must be one of {choices}, "
                         f"got {value!r}")
    return value


def apply_matmul_precision(name: str) -> None:
    """Pin full fp32 for matmuls and convolutions on the card, and f32 sums
    for bf16 products.

    cuDNN runs fp32 convolutions in TF32 unless told otherwise, which would
    cut the depthwise conv and the char CNN to ~3 decimal digits.  cuBLAS
    may reduce bf16 products in bf16 unless told otherwise; the JAX package
    sums them in f32 (``preferred_element_type=f32``).
    """
    torch.set_float32_matmul_precision(TORCH_MATMUL_PRECISION[name])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; raises for ``cuda`` without a card, so
    nothing moves to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


@dataclass
class PathsConfig:
    ckpt_dir: str = "./ckpt"
    cache_dir: str = "./data_pkl/"
    feature_path: str = ""
    glove_path: str = ""
    train_path: str = ""
    test_path: str = ""
    val_path: str = ""


@dataclass
class TrainConfig:
    # Read by the training and sweep slices; carried here so a bundle's
    # meta.json round-trips field for field.
    epochs: int = 50
    batch_size: int = 16
    lr: float = 1e-4
    droprate: float = 0.2
    clip_norm: float = 1.0
    weight_decay: float = 0.01
    eval_batch_size: Optional[int] = None
    infer_batch_size: Optional[int] = None
    seed: int = 12345
    save_state_every: int = 0
    mc_droprate: float = 0.0
    fold_mc: bool = False
    mc_dtype: str = "float32"
    rng_impl: str = "rbg"
    infer_rng_impl: str = "rbg"
    sweep_backend: str = "flax"
    fused_block: int = 8
    fused_mxu_bf16: bool = False
    host_streaming: Optional[bool] = None
    hbm_budget_gb: float = 12.0

    def __post_init__(self):
        self.mc_dtype = _canon_dtype(self.mc_dtype, "train.mc_dtype")
        _check_choice(self.sweep_backend, "train.sweep_backend",
                      ("flax", "fused"))


@dataclass
class ModelConfig:
    name: str = "SeqPAN"
    max_vlen: int = 64
    max_tlen: int = 30
    vdim: int = 1024
    dim: int = 128
    num_heads: int = 8
    word_dim: int = 300
    char_dim: int = 50
    attn_layer: int = 2
    num_chars: int = 0
    num_words: int = 0
    matmul_precision: str = "default"
    span_decode: str = "xla"
    compute_dtype: str = "float32"
    feature_dtype: str = "float32"

    def __post_init__(self):
        self.compute_dtype = _canon_dtype(self.compute_dtype,
                                          "model.compute_dtype")
        self.feature_dtype = _canon_dtype(self.feature_dtype,
                                          "model.feature_dtype",
                                          storage=True)
        _check_choice(self.span_decode, "model.span_decode",
                      ("xla", "pallas"))
        _check_choice(self.matmul_precision, "model.matmul_precision",
                      tuple(TORCH_MATMUL_PRECISION))


@dataclass
class LossConfig:
    match_lambda: float = 1.0
    tau: float = 0.3
    no_gumbel: bool = True


@dataclass
class Config:
    task: str = "charades"
    suffix: str = ""
    paths: PathsConfig = field(default_factory=PathsConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        def _sub(dc_cls, sub: dict[str, Any]):
            names = {f.name for f in dataclasses.fields(dc_cls)}
            return dc_cls(**{k: v for k, v in sub.items() if k in names})

        return cls(
            task=d.get("task", "charades"),
            suffix=d.get("suffix", "") or "",
            paths=_sub(PathsConfig, d.get("paths", {}) or {}),
            train=_sub(TrainConfig, d.get("train", {}) or {}),
            model=_sub(ModelConfig, d.get("model", {}) or {}),
            loss=_sub(LossConfig, d.get("loss", {}) or {}),
        )

    @classmethod
    def load(cls, path: str) -> "Config":
        return cls.from_dict(load_yaml(path))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        import yaml

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf8") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def derive_round(self, round_idx: int,
                     data_root: str = "./data") -> "Config":
        """Per-round paths and suffix (``hual_tpu.config.Config.derive_round``)."""
        round_dir = os.path.join(data_root, f"{self.task}_re{round_idx}")
        return dataclasses.replace(
            self,
            suffix=f"re{round_idx}",
            paths=dataclasses.replace(
                self.paths,
                train_path=os.path.join(round_dir, "train.json"),
                test_path=os.path.join(round_dir, "test.json"),
            ),
        )

    @property
    def eval_batch_size(self) -> int:
        return self.train.eval_batch_size or max(96, self.train.batch_size)

    @property
    def infer_batch_size(self) -> int:
        return self.train.infer_batch_size or max(96, self.train.batch_size)

    def model_dir(self) -> str:
        """Checkpoint directory of this round: ``<ckpt_dir>/<task>_<suffix>``.
        The reference formats ``ckpt/{task}_`` without the suffix, so each
        round overwrote the last; the suffix is kept so rounds resume, and
        the reference layout stays for an empty suffix."""
        name = f"{self.task}_{self.suffix}" if self.suffix else f"{self.task}_"
        return os.path.join(self.paths.ckpt_dir, name)
