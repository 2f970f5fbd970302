"""Port reference TF1 SeqPAN checkpoints to the port's weights, without
TensorFlow (counterpart of ``hual_tpu/utils/tf1_port.py``).

The reference saves TF1 ``Saver`` checkpoints (reference ``main.py:57,
71-75``).  The name map is the JAX package's, copied: every model variable
of the reference graph lands on the leaf of the JAX param tree with the
same shape, no transposes.  :func:`flat_params` flattens that tree to the
``params/a/b/leaf`` keys of ``weights.py`` (the layout of a serving
bundle's ``params.npz`` and of ``best.npz``).

:func:`load_tf1_checkpoint` reads the checkpoint with NumPy and ``struct``
alone, so a reference checkpoint can be ported on a machine without
TensorFlow.  A ``Saver`` checkpoint is a V2 tensor bundle:

* ``<prefix>.index`` is a table of sorted keys: data blocks of
  prefix-compressed entries, each block followed by a 5-byte trailer (the
  compression type, 0 for none, and a masked crc32c), an index block of
  block handles, and a 48-byte footer ending in a magic number;
* the empty key holds a ``BundleHeaderProto`` (shard count, endianness);
  every other key is a variable name holding a ``BundleEntryProto`` (dtype,
  shape, shard, offset, size, the masked crc32c of the tensor's bytes);
* ``<prefix>.data-<shard>-of-<shards>`` holds the raw little-endian bytes.

The protobuf messages are decoded by hand (varints and length-delimited
fields); the crc32c of every tensor is checked.

The CLI wrapper is ``tools/torch_port_tf1_checkpoint.py``.
"""

from __future__ import annotations

import codecs
import functools
import os
import struct
from typing import Any, Iterator, Mapping, Optional

import numpy as np

# optimizer slot suffixes created by the reference's hand-rolled AdamW
# (reference models/ops.py:156,161); not model parameters
_SLOT_SUFFIXES = ("/adam_m", "/adam_v")
_NON_PARAM_NAMES = ("global_step",)
# the frozen GloVe matrix is a non-trainable tf.Variable saved inside the
# reference checkpoint (reference models/modules.py:10); here the word
# vectors are a pipeline input, not a model parameter
WORD_TABLE = "word_embs/word_table"


def tf_name_to_flax_path(name: str) -> tuple:
    """Map a reference TF1 variable name onto the JAX param-tree path.

    Scope by scope the graphs line up; the deliberate differences:
      * ``matching_loss`` scope -> ``matching_head``
      * the reference nests LN/attn/FFN of feature_encoder in an extra
        ``multihead_attention_block`` scope (reference
        models/modules.py:128) that the FeatureEncoder flattens: dropped
      * TF layer_norm variables are ``layer_norm_scale``/``layer_norm_bias``
        (reference models/layers.py:11-12); the leaves are ``scale``/``bias``
    """
    parts = name.split(":")[0].split("/")
    parts = [p for p in parts if p != "multihead_attention_block"]
    if parts[0] == "matching_loss":
        parts[0] = "matching_head"
    tail = {"layer_norm_scale": "scale", "layer_norm_bias": "bias"}
    parts[-1] = tail.get(parts[-1], parts[-1])
    return tuple(parts)


def is_model_variable(name: str) -> bool:
    """True for model parameters; False for optimizer slots, bookkeeping,
    and the frozen GloVe table (returned separately by the port)."""
    base = name.split(":")[0]
    if base in _NON_PARAM_NAMES or base == WORD_TABLE:
        return False
    return not base.endswith(_SLOT_SUFFIXES)


def params_from_tf_values(values: Mapping[str, np.ndarray]) -> dict:
    """Nest a ``{tf_variable_name: array}`` dict into a param tree
    ``{"params": {...}}``.  Optimizer slot variables and ``global_step``
    are skipped; duplicate destination paths are an error."""
    root: dict[str, Any] = {}
    seen: dict[tuple, str] = {}
    for name, value in values.items():
        if not is_model_variable(name):
            continue
        path = tf_name_to_flax_path(name)
        if path in seen:
            raise ValueError(
                f"TF variables {seen[path]!r} and {name!r} both map to "
                f"flax path {path}")
        seen[path] = name
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"path conflict at {part!r} for {name!r}")
        node[path[-1]] = np.asarray(value)
    if not root:
        raise ValueError("no model variables found in the checkpoint")
    return {"params": root}


def flat_params(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """A nested param tree -> ``{"params/a/b/leaf": array}``, the flat
    layout ``weights.load_jax_params`` takes (``hual_tpu/serve.py``'s
    ``_flatten_params``)."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(flat_params(value, path))
        else:
            out[path] = np.asarray(value)
    return out


# -- crc32c (Castagnoli), as TF checks it -------------------------------------
def _crc_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78),
                         table >> 1).astype(np.uint32)
    return table


_CRC_TABLE = _crc_table()
_CRC_LIST = _CRC_TABLE.tolist()


@functools.cache
def _zeros_operator(n: int) -> tuple[list[int], ...]:
    """The linear map a crc register undergoes over ``n`` zero bytes, as
    four 256-entry tables (one per byte of the register)."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(n):
        basis = _CRC_TABLE[basis & 0xFF] ^ (basis >> 8)
    e = np.arange(256, dtype=np.uint32)
    tables = []
    for byte in range(4):
        t = np.zeros(256, np.uint32)
        for bit in range(8):
            t ^= np.where((e >> bit) & 1, basis[8 * byte + bit], 0).astype(np.uint32)
        tables.append(t.tolist())
    return tuple(tables)


def crc32c(data) -> int:
    """crc32c of a bytes-like object.  Long buffers run as equal lanes in
    NumPy, one byte of every lane a step; the lanes' crcs are then joined
    (crc(A||B) is crc(A) carried over len(B) zero bytes, xor crc(B))."""
    buf = np.frombuffer(data, np.uint8)
    # lanes of a power-of-two length near sqrt(n): ~n^0.5 NumPy steps and
    # ~n^0.5 joins, each table of the join cached per length
    lane = 1 << max(6, int(np.log2(max(buf.size, 1))) // 2)
    n_lanes = buf.size // lane if buf.size >= 4 * lane else 0
    reg = 0xFFFFFFFF
    if n_lanes:
        columns = np.ascontiguousarray(buf[:n_lanes * lane].reshape(n_lanes, lane).T)
        crc = np.full(n_lanes, 0xFFFFFFFF, np.uint32)
        for column in columns:
            crc = _CRC_TABLE.take((crc ^ column) & 0xFF) ^ (crc >> 8)
        crc ^= np.uint32(0xFFFFFFFF)
        t0, t1, t2, t3 = _zeros_operator(lane)
        total, *rest = crc.tolist()
        for c in rest:
            total = (t0[total & 0xFF] ^ t1[(total >> 8) & 0xFF]
                     ^ t2[(total >> 16) & 0xFF] ^ t3[total >> 24] ^ c)
        reg = total ^ 0xFFFFFFFF
    for b in buf[n_lanes * lane:].tolist():
        reg = _CRC_LIST[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """The masked crc32c TF stores (``crc32c::Mask``)."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


# -- the V2 tensor bundle -----------------------------------------------------
_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_BYTES = 48
_BLOCK_TRAILER = 5
_COMPRESSION = {0: "none", 1: "snappy", 2: "zlib"}
# tensorflow/core/framework/types.proto
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 9: np.int64,
           10: np.bool_}


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 10 bytes")


def _fields(msg: bytes) -> Iterator[tuple[int, Any]]:
    """(field number, value) of each field of a protobuf message: an int
    for varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(msg):
        tag, pos = _varint(msg, pos)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(msg, pos)
        elif wire == 1:
            value, = struct.unpack_from("<Q", msg, pos)
            pos += 8
        elif wire == 2:
            n, pos = _varint(msg, pos)
            value = msg[pos:pos + n]
            if len(value) != n:
                raise ValueError("truncated protobuf field")
            pos += n
        elif wire == 5:
            value, = struct.unpack_from("<I", msg, pos)
            pos += 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not read")
        yield number, value


def _block(table: bytes, handle: bytes, where: str) -> bytes:
    """The contents of the block a handle (varint offset, varint size)
    points at; only uncompressed blocks are read."""
    offset, pos = _varint(handle, 0)
    size, _ = _varint(handle, pos)
    if offset + size + _BLOCK_TRAILER > len(table):
        raise ValueError(f"{where}: block at {offset}+{size} runs past the file")
    kind = table[offset + size]
    if kind != 0:
        raise ValueError(f"{where}: block at offset {offset} has compression "
                         f"type {kind} ({_COMPRESSION.get(kind, 'unknown')}); "
                         "only uncompressed (type 0) tables are read")
    return table[offset:offset + size]


def _block_entries(block: bytes, where: str) -> Iterator[tuple[bytes, bytes]]:
    """(key, value) of each entry: shared prefix length, unshared length,
    value length (varints), the key's unshared bytes, the value; the
    restart offsets (uint32 each) and their count close the block."""
    if len(block) < 4:
        raise ValueError(f"{where}: block of {len(block)} bytes")
    n_restarts, = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise ValueError(f"{where}: {n_restarts} restarts in a block of "
                         f"{len(block)} bytes")
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        n, pos = _varint(block, pos)
        if shared > len(key) or pos + unshared + n > end:
            raise ValueError(f"{where}: corrupt block entry at {pos}")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + n]
        pos += n


def _table_entries(table: bytes, where: str) -> Iterator[tuple[bytes, bytes]]:
    """Every (key, value) of a table file, in key order."""
    if len(table) < _FOOTER_BYTES:
        raise ValueError(f"{where}: {len(table)} bytes, shorter than a table footer")
    footer = table[-_FOOTER_BYTES:]
    lo, hi = struct.unpack_from("<II", footer, _FOOTER_BYTES - 8)
    if (hi << 32) | lo != _TABLE_MAGIC:
        raise ValueError(f"{where}: not a TF table (magic {(hi << 32) | lo:#x})")
    _, pos = _varint(footer, 0)                   # the metaindex handle
    _, pos = _varint(footer, pos)
    index = _block(table, footer[pos:], where)
    for _, handle in _block_entries(index, where):
        yield from _block_entries(_block(table, handle, where), where)


def _shape(msg: bytes) -> tuple[int, ...]:
    dims = []
    for number, value in _fields(msg):
        if number == 2:                           # TensorShapeProto.dim
            dims.append(next((v for n, v in _fields(value) if n == 1), 0))
        elif number == 3 and value:               # unknown_rank
            raise ValueError("a tensor of unknown rank")
    return tuple(dims)


def _entry(name: str, msg: bytes) -> dict:
    """A ``BundleEntryProto``'s fields."""
    entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
             "crc32c": None}
    for number, value in _fields(msg):
        if number == 1:
            entry["dtype"] = value
        elif number == 2:
            entry["shape"] = _shape(value)
        elif number == 3:
            entry["shard_id"] = value
        elif number == 4:
            entry["offset"] = value
        elif number == 5:
            entry["size"] = value
        elif number == 6:
            entry["crc32c"] = value
        elif number == 7:
            raise ValueError(f"variable {name!r} is saved in slices "
                             "(a partitioned variable); slices are not read")
    if entry["dtype"] not in _DTYPES:
        raise ValueError(f"variable {name!r} has dtype enum {entry['dtype']}; "
                         "only DT_FLOAT, DT_DOUBLE, DT_INT32, DT_INT64 and "
                         "DT_BOOL are read")
    return entry


def latest_checkpoint(directory: str) -> str:
    """The prefix a directory's ``checkpoint`` pointer file names
    (``model_checkpoint_path``; a relative path is joined to the
    directory), as ``tf.train.latest_checkpoint`` resolves it; raises
    FileNotFoundError when there is no pointer or no ``<prefix>.index``."""
    pointer = os.path.join(directory, "checkpoint")
    prefix = None
    if os.path.isfile(pointer):
        with open(pointer, encoding="utf-8") as f:
            for line in f:
                key, _, value = line.strip().partition(":")
                if key.strip() == "model_checkpoint_path":
                    text = value.strip()
                    if len(text) < 2 or text[0] != '"' or text[-1] != '"':
                        raise ValueError(f"{pointer}: malformed line {line!r}")
                    prefix = codecs.escape_decode(text[1:-1])[0].decode("utf-8")
                    break
    if prefix is None:
        raise FileNotFoundError(f"no TF checkpoint pointer under {directory!r}")
    if not os.path.isabs(prefix):
        prefix = os.path.join(directory, prefix)
    if not os.path.isfile(prefix + ".index"):
        raise FileNotFoundError(f"the checkpoint pointer under {directory!r} "
                                f"names {prefix!r}, which has no .index")
    return prefix


def load_tf1_checkpoint(ckpt_prefix: str) -> dict:
    """Every variable of a TF1 ``Saver`` checkpoint as NumPy arrays, as
    ``reader.get_tensor`` returns them (a scalar as a NumPy scalar).

    ``ckpt_prefix`` is the Saver path stem (the reference's
    ``ckpt/<task>_/best_SeqPAN.ckpt-<step>``) or a directory holding a
    ``checkpoint`` pointer file, in which case the latest is used, as the
    reference's ``tf.train.latest_checkpoint`` does (reference
    main.py:93,109).  Raises ValueError for a compressed table, a
    big-endian bundle, a dtype other than float32/64, int32/64 and bool, a
    sliced variable, a size that does not match the shape, or a crc
    mismatch.
    """
    if os.path.isdir(ckpt_prefix):
        ckpt_prefix = latest_checkpoint(ckpt_prefix)
    index_path = ckpt_prefix + ".index"
    with open(index_path, "rb") as f:
        table = f.read()
    entries = _table_entries(table, index_path)
    first = next(entries, None)
    if first is None or first[0] != b"":
        raise ValueError(f"{index_path}: no bundle header under the empty key")
    header = dict(_fields(first[1]))
    n_shards = header.get(1, 0)
    if header.get(2, 0) != 0:
        raise ValueError(f"{index_path}: a big-endian bundle; only "
                         "little-endian bundles are read")
    files: dict[int, Any] = {}
    out: dict[str, Any] = {}
    try:
        for key, msg in entries:
            name = key.decode("utf-8")
            e = _entry(name, msg)
            dtype = np.dtype(_DTYPES[e["dtype"]])
            want = int(np.prod(e["shape"], dtype=np.int64)) * dtype.itemsize
            if e["size"] != want:
                raise ValueError(f"variable {name!r}: {e['size']} bytes for "
                                 f"shape {e['shape']} of {dtype}")
            if not 0 <= e["shard_id"] < n_shards:
                raise ValueError(f"variable {name!r}: shard {e['shard_id']} "
                                 f"of {n_shards}")
            f = files.get(e["shard_id"])
            if f is None:
                f = files[e["shard_id"]] = open(
                    f"{ckpt_prefix}.data-{e['shard_id']:05d}-of-{n_shards:05d}", "rb")
            f.seek(e["offset"])
            raw = bytearray(e["size"])
            if f.readinto(raw) != e["size"]:
                raise ValueError(f"variable {name!r}: its data file ends "
                                 f"before offset {e['offset']} + {e['size']}")
            if mask_crc(crc32c(raw)) != e["crc32c"]:
                raise ValueError(f"variable {name!r}: crc32c mismatch "
                                 "(the data file is corrupt)")
            value = np.frombuffer(raw, dtype).reshape(e["shape"])
            out[name] = value[()] if value.ndim == 0 else value
    finally:
        for f in files.values():
            f.close()
    return out


def port_checkpoint(ckpt_prefix: str, out: str
                    ) -> tuple[dict[str, np.ndarray], Optional[np.ndarray]]:
    """Port a reference TF1 checkpoint to ``out``, a ``best.npz`` in the
    flat layout of ``weights.py`` (float32) that ``Trainer.restore(out)``,
    ``cli --checkpoint`` and ``Predictor`` read.

    The JAX package writes an Orbax directory here; the port's checkpoints
    are ``best.npz`` files.  If the checkpoint carries the frozen GloVe
    matrix (``word_embs/word_table``, present in every reference Saver
    checkpoint), it is written as ``<out stem>_word_vectors.npy`` so the
    ported model can run against exactly the embedding rows it was trained
    with.

    Returns ``(flat_params, word_vectors_or_None)``.
    """
    values = load_tf1_checkpoint(ckpt_prefix)
    flat = {k: np.asarray(v, np.float32)
            for k, v in flat_params(params_from_tf_values(values)).items()}
    out = os.path.abspath(out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        np.savez(f, **flat)
    wv = values.get(WORD_TABLE)
    if wv is None:  # Saver readers drop the ':0' suffix, but be permissive
        wv = values.get(WORD_TABLE + ":0")
    if wv is not None:
        np.save(word_vectors_path(out), np.asarray(wv, np.float32))
    return flat, wv


def word_vectors_path(out: str) -> str:
    """Where :func:`port_checkpoint` writes the GloVe matrix of ``out``."""
    out = os.path.abspath(out)
    return (out[:-len(".npz")] if out.endswith(".npz") else out) + "_word_vectors.npy"
