"""Write a TF1 ``Saver`` checkpoint (a V2 tensor bundle) with NumPy alone.

The machine with the card has no TensorFlow, so ``chip_smoke.py`` writes
its reference checkpoint with this helper; ``tests/test_torch_tf1_port.py``
proves that TensorFlow's own reader reads what it writes, bit for bit.  The
layout is the one ``hual_tpu_torch/utils/tf1_port.py`` reads: a table of
sorted keys (prefix-compressed data blocks with a restart every
``RESTART_INTERVAL`` entries, an index block, an empty metaindex block and
the 48-byte footer), the bundle header under the empty key, one
``BundleEntryProto`` per variable, and one data file.

:func:`reference_names` turns the port's flat params into the reference
graph's variable names (the inverse of ``tf_name_to_flax_path``), and
:func:`saver_values` adds what a reference ``Saver`` checkpoint also holds:
the Adam slots, ``global_step`` and the frozen GloVe table.
"""

from __future__ import annotations

import os
import struct
from typing import Mapping

import numpy as np

from hual_tpu_torch.utils.tf1_port import crc32c, mask_crc

RESTART_INTERVAL = 16
# numpy dtype -> TF DataType enum (tensorflow/core/framework/types.proto);
# float16 (DT_HALF) is here for the reader's refusal
DTYPE_ENUMS = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
               np.dtype(np.int32): 3, np.dtype(np.int64): 9,
               np.dtype(np.bool_): 10, np.dtype(np.float16): 19}
# feature_encoder's scopes under the reference's extra
# multihead_attention_block (hual_tpu/models/modules.py:164-173)
_FEATURE_ENCODER_BLOCK = ("layer_norm_1", "top_self_attention", "layer_norm_2",
                          "dense")


def reference_names(flat: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``{"params/a/b/leaf": array}`` -> the reference graph's
    ``{tf_variable_name: array}``: ``matching_head`` is ``matching_loss``,
    feature_encoder's attention block sits under
    ``multihead_attention_block``, a LayerNorm's leaves are
    ``layer_norm_scale`` / ``layer_norm_bias``."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")[1:]
        if parts[0] == "matching_head":
            parts[0] = "matching_loss"
        for i, part in enumerate(parts[:-1]):
            if part == "feature_encoder" and parts[i + 1] in _FEATURE_ENCODER_BLOCK:
                parts.insert(i + 1, "multihead_attention_block")
                break
        layer_norm = key.rsplit("/", 1)[0] + "/scale" in flat
        if layer_norm and parts[-1] in ("scale", "bias"):
            parts[-1] = "layer_norm_" + parts[-1]
        out["/".join(parts)] = value
    return out


def saver_values(flat: Mapping[str, np.ndarray], word_table: np.ndarray,
                 step: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
    """What a reference ``Saver`` checkpoint of ``flat`` holds: every model
    variable, its ``/adam_m`` and ``/adam_v`` slots (seeded random),
    ``global_step`` (int64) and ``word_embs/word_table``."""
    values = {}
    for name, value in reference_names(flat).items():
        values[name] = np.asarray(value, np.float32)
        for slot in ("/adam_m", "/adam_v"):
            values[name + slot] = rng.normal(size=np.shape(value)).astype(np.float32)
    values["global_step"] = np.asarray(step, np.int64)
    values["word_embs/word_table"] = np.asarray(word_table, np.float32)
    return values


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, value) -> bytes:
    """A varint field (int) or a length-delimited one (bytes)."""
    if isinstance(value, bytes):
        return _varint(number << 3 | 2) + _varint(len(value)) + value
    return _varint(number << 3) + _varint(value)


def _entry(array: np.ndarray, offset: int, crc: int, sliced: bool) -> bytes:
    """A ``BundleEntryProto``, zero-valued fields left out as proto3 does."""
    shape = b"".join(_field(2, _field(1, d)) for d in array.shape)
    msg = _field(1, DTYPE_ENUMS[array.dtype]) + _field(2, shape)
    if offset:
        msg += _field(4, offset)
    if array.nbytes:
        msg += _field(5, array.nbytes)
    msg += struct.pack("<BI", 6 << 3 | 5, mask_crc(crc))
    return msg + (_field(7, b"") if sliced else b"")


def _block(entries: list[tuple[bytes, bytes]], restart_interval: int) -> bytes:
    out, restarts, prev = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % restart_interval:
            while (shared < min(len(prev), len(key))
                   and prev[shared] == key[shared]):
                shared += 1
        else:
            restarts.append(len(out))
        out += (_varint(shared) + _varint(len(key) - shared)
                + _varint(len(value)) + key[shared:] + value)
        prev = key
    restarts = restarts or [0]
    out += struct.pack(f"<{len(restarts) + 1}I", *restarts, len(restarts))
    return bytes(out)


def _table(entries: list[tuple[bytes, bytes]], block_bytes: int,
           block_type: int) -> bytes:
    """The table file of sorted ``entries``: data blocks of about
    ``block_bytes``, each with its trailer (``block_type`` and the masked
    crc32c of the block and that byte), the index block, the metaindex
    block and the footer."""
    out, index = bytearray(), []

    def put(block: bytes) -> bytes:
        handle = _varint(len(out)) + _varint(len(block))
        trailer = bytes([block_type])
        out.extend(block + trailer + struct.pack("<I", mask_crc(crc32c(block + trailer))))
        return handle

    chunk, size = [], 0
    for key, value in entries:
        chunk.append((key, value))
        size += len(key) + len(value)
        if size >= block_bytes:
            index.append((chunk[-1][0], put(_block(chunk, RESTART_INTERVAL))))
            chunk, size = [], 0
    if chunk:
        index.append((chunk[-1][0], put(_block(chunk, RESTART_INTERVAL))))
    meta = put(_block([], RESTART_INTERVAL))
    index_handle = put(_block(index, 1))
    footer = (meta + index_handle).ljust(40, b"\0")
    out += footer + struct.pack("<II", 0x8B80FB57, 0xDB477524)
    return bytes(out)


def write_bundle(prefix: str, values: Mapping[str, np.ndarray],
                 block_bytes: int = 4096, block_type: int = 0,
                 sliced: tuple[str, ...] = ()) -> str:
    """Write ``values`` as ``<prefix>.index`` and
    ``<prefix>.data-00000-of-00001``; returns ``prefix``.  ``block_type``
    and ``sliced`` write what a reader must refuse: a compressed table, a
    variable saved in slices."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    header = _field(1, 1) + _field(3, _field(1, 1))   # 1 shard, producer 1
    entries, offset = [(b"", header)], 0
    with open(prefix + ".data-00000-of-00001", "wb") as data:
        for name in sorted(values, key=lambda n: n.encode("utf-8")):
            array = np.asarray(values[name])
            raw = array.tobytes()
            data.write(raw)
            entries.append((name.encode("utf-8"),
                            _entry(array, offset, crc32c(raw), name in sliced)))
            offset += len(raw)
    with open(prefix + ".index", "wb") as f:
        f.write(_table(entries, block_bytes, block_type))
    return prefix


def write_pointer(directory: str, prefix: str) -> None:
    """The directory's ``checkpoint`` pointer file, naming ``prefix`` (as
    TF writes it: the path as given, quoted)."""
    with open(os.path.join(directory, "checkpoint"), "w", encoding="utf-8") as f:
        f.write(f'model_checkpoint_path: "{prefix}"\n'
                f'all_model_checkpoint_paths: "{prefix}"\n')
