"""Orbax checkpoints (``orbax.checkpoint.StandardCheckpointer``'s format)
read and written without Orbax, tensorstore or zstandard.

A checkpoint directory holds JSON files (``_METADATA``: the tree's key
paths and each leaf's kind; ``_CHECKPOINT_METADATA``; ``_sharding``;
``array_metadatas/process_N``) and the arrays, which live in an OCDBT
key-value store (``utils/ocdbt.py``) or, for a tree written with
``use_ocdbt=False``, as plain files.  An array is a zarr v2 entry
(``StandardCheckpointer``'s default) or, in a tree written with
``use_zarr3=True``, a zarr v3 one:

* v2: ``<a.b.c>/.zarray`` (JSON: shape, chunks, dtype, compressor) and
  ``<a.b.c>/<i.j...>``, one chunk each;
* v3: ``<a.b.c>/zarr.json`` (``node_type`` ``array``, a ``regular`` chunk
  grid, ``data_type``, ``fill_value``, the codec chain) and the chunks
  under the ``default`` chunk-key encoding, ``<a.b.c>/c/<i>/<j>...``
  (``c`` alone for a scalar), or the ``v2`` one, ``<a.b.c>/<i.j...>``.
  Orbax writes one ``sharding_indexed`` codec per array: each stored
  chunk (a shard) holds inner chunks, each encoded by the inner codecs
  (``bytes`` little endian, then ``zstd``), and an index of one
  ``(offset, size)`` uint64 pair per inner chunk (2^64-1 twice for an
  inner chunk left at ``fill_value``), encoded by ``bytes`` and
  ``crc32c``, at the shard's end (or start).  The reader also takes the
  ``transpose``, ``gzip`` and ``crc32c`` codecs and big-endian ``bytes``;
  any other codec raises, naming it.

``read_tree`` gives the nested dicts and lists the tree was saved from
(named tuples come back as dicts, tuples as lists, as Orbax restores them
without a template): arrays as numpy, bfloat16 ones as ``torch.bfloat16``
tensors with the same bits, scalars as Python numbers, empty nodes as
``None`` or ``{}``.  ``write_tree`` writes such a tree (numpy arrays,
tensors, Python numbers) in the file set Orbax writes, uncompressed, which
``StandardCheckpointer.restore`` reads with or without a template.
"""

from __future__ import annotations

import ast
import base64
import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .ocdbt import OcdbtStore, crc32c, write_ocdbt

METADATA = "_METADATA"
_CONVERT = ("convert it to npz with stereo_tpu.models.save_params_npz "
            "(stereo_tpu.models.load_params, then save_params_npz) on a "
            "machine with JAX")
# The zarr dtypes of JAX's trees (bfloat16 read as its 16 bits).
_DTYPES = {"<f2": np.float16, "<f4": np.float32, "<f8": np.float64,
           "<i4": np.int32, "<i8": np.int64, "|u1": np.uint8,
           "|b1": np.bool_, "bfloat16": np.uint16}
# zarr v3 data types (bfloat16 read as its 16 bits).
_DTYPES3 = {"float16": np.float16, "float32": np.float32,
            "float64": np.float64, "int32": np.int32, "int64": np.int64,
            "uint8": np.uint8, "bool": np.bool_, "bfloat16": np.uint16}
_EMPTY = 2 ** 64 - 1         # an inner chunk's index entry when not stored
_KEY_DICT, _KEY_SEQUENCE = 2, 1


def is_orbax_dir(path: str) -> bool:
    """A non-empty directory: what both packages' loaders take for an
    Orbax checkpoint."""
    return os.path.isdir(path) and bool(os.listdir(path))


def _check_format(root: str) -> None:
    """Refuse the formats this reader does not take, naming them."""
    names = set(os.listdir(root))
    if not os.path.isfile(os.path.join(root, METADATA)):
        if "checkpoint" in names or any(n.endswith(".msgpack")
                                         for n in names):
            raise ValueError(f"{root!r} is a pre-OCDBT msgpack Orbax tree, "
                             f"which the port does not read; {_CONVERT}")
        raise ValueError(f"{root!r} is not an Orbax checkpoint (no "
                         f"{METADATA})")


class _Source:
    """The tree's zarr entries: an OCDBT store, else plain files."""

    def __init__(self, root: str, use_ocdbt: bool):
        self.root = root
        has_ocdbt = os.path.isfile(os.path.join(root, "manifest.ocdbt")) or \
            any(n.startswith("ocdbt.process_") for n in os.listdir(root))
        self.store = OcdbtStore(root) if (use_ocdbt and has_ocdbt) else None

    def get(self, key: str):
        if self.store is not None:
            return self.store.get(key)
        path = os.path.join(self.root, *key.split("/"))
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


def _decompress(raw: bytes, compressor, key: str) -> bytes:
    from .. import _native

    if compressor is None:
        return raw
    kind = compressor.get("id")
    if kind == "zstd":
        return _native.zstd_decompress(raw)
    if kind in ("zlib", "gzip"):
        return _native.inflate(raw)
    raise ValueError(f"{key}: zarr compressor {kind!r} is not supported "
                     f"(zstd, zlib, gzip or none)")


def _read_array(source: _Source, name: str):
    """One zarr v2 or v3 array, all its chunks assembled."""
    raw = source.get(f"{name}/.zarray")
    if raw is None:
        raw = source.get(f"{name}/zarr.json")
        if raw is None:
            raise ValueError(f"{source.root!r}: no zarr metadata for "
                             f"{name!r}")
        return _read_array3(source, name, json.loads(raw))
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')} "
                         f"is not supported")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: only C order without filters is read")
    code = meta["dtype"]
    if code not in _DTYPES:
        raise ValueError(f"{name}: zarr dtype {code!r} is not supported")
    dtype = np.dtype(_DTYPES[code])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.empty(shape, dtype)
    if fill is None or code == "bfloat16":
        out.fill(0)              # Orbax writes every chunk; bf16 fill is 0
    else:
        out.fill(fill)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid) if shape else [()]:
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        raw = source.get(key)
        if raw is None:
            continue
        chunk = np.frombuffer(_decompress(raw, meta.get("compressor"), key),
                              dtype)
        if chunk.size != int(np.prod(chunks)):
            raise ValueError(f"{key}: {chunk.size} values, expected "
                             f"{int(np.prod(chunks))}")
        chunk = chunk.reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return _bfloat16(out) if code == "bfloat16" else out


def _bfloat16(bits: np.ndarray) -> torch.Tensor:
    """A bfloat16 tensor of the uint16 ``bits``."""
    return torch.from_numpy(bits.astype(np.int16, copy=False)).view(
        torch.bfloat16)


def _fill3(meta: dict, dtype: np.dtype, name: str):
    """A v3 array's ``fill_value`` as a value of ``dtype`` (bfloat16 as
    its bits): a number, a bool, ``"NaN"``, ``"Infinity"``,
    ``"-Infinity"`` or the value's bits in hex (``"0x..."``)."""
    fill = meta.get("fill_value", 0)
    code = meta["data_type"]
    if isinstance(fill, str) and fill.startswith("0x"):
        bits = int(fill, 16)
        if code == "bfloat16":
            return np.uint16(bits)
        return np.array([bits], f"<u{dtype.itemsize}").view(dtype)[0]
    if isinstance(fill, str):
        fill = {"NaN": float("nan"), "Infinity": float("inf"),
                "-Infinity": float("-inf")}.get(fill)
        if fill is None:
            raise ValueError(f"{name}: fill_value {meta['fill_value']!r} "
                             f"is not read")
    if code == "bfloat16":
        return np.uint16(torch.tensor(float(fill), dtype=torch.bfloat16)
                         .view(torch.int16).item() & 0xFFFF)
    return np.array(fill).astype(dtype)


def _split_codecs(codecs: List[dict], name: str):
    """``(array->array codecs, the array->bytes codec, bytes->bytes
    codecs)`` of a v3 codec chain, in the order they encode."""
    codecs = list(codecs)
    cut = next((i for i, c in enumerate(codecs)
                if c["name"] != "transpose"), None)
    if cut is None or codecs[cut]["name"] not in ("bytes",
                                                  "sharding_indexed"):
        raise ValueError(f"{name}: zarr v3 codec chain "
                         f"{[c['name'] for c in codecs]} has no bytes or "
                         f"sharding_indexed codec")
    return codecs[:cut], codecs[cut], codecs[cut + 1:]


def _unbytes(raw: bytes, codec: dict, name: str) -> bytes:
    """One bytes->bytes codec undone."""
    from .. import _native

    kind = codec["name"]
    if kind == "zstd":
        return _native.zstd_decompress(raw)
    if kind == "gzip":
        return _native.inflate(raw)
    if kind == "crc32c":
        if len(raw) < 4:
            raise ValueError(f"{name}: {len(raw)} bytes cannot end in a "
                             f"crc32c")
        body, want = raw[:-4], int.from_bytes(raw[-4:], "little")
        if crc32c(body) != want:
            raise ValueError(f"{name}: crc32c mismatch")
        return body
    raise ValueError(f"{name}: zarr v3 codec {kind!r} is not supported "
                     f"(bytes, sharding_indexed, transpose, zstd, gzip, "
                     f"crc32c)")


def _transposed(shape: Tuple[int, ...], codec: dict, name: str) -> list:
    """The axis order of a ``transpose`` codec for an array of ``shape``
    (the encoded array's axis k is the decoded array's axis order[k])."""
    order = codec.get("configuration", {}).get("order")
    if sorted(order) != list(range(len(shape))):
        raise ValueError(f"{name}: transpose order {order!r} is not a "
                         f"permutation of {len(shape)} axes")
    return list(order)


def _decode3(raw: bytes, codecs: List[dict], shape: Tuple[int, ...],
             dtype: np.dtype, fill, name: str) -> np.ndarray:
    """A v3 chunk of ``shape`` decoded through ``codecs``."""
    to_array, to_bytes, on_bytes = _split_codecs(codecs, name)
    for codec in reversed(on_bytes):
        raw = _unbytes(raw, codec, name)
    orders, encoded = [], tuple(shape)
    for codec in to_array:
        order = _transposed(encoded, codec, name)
        orders.append(order)
        encoded = tuple(encoded[k] for k in order)
    config = to_bytes.get("configuration", {})
    if to_bytes["name"] == "bytes":
        order = {"little": "<", "big": ">"}.get(config.get("endian"), "=")
        count = int(np.prod(encoded))
        if len(raw) != count * dtype.itemsize:
            raise ValueError(f"{name}: a chunk of {len(raw)} bytes, "
                             f"expected {count * dtype.itemsize}")
        out = np.frombuffer(raw, dtype.newbyteorder(order)).astype(
            dtype).reshape(encoded)
    else:
        out = _unshard(raw, config, encoded, dtype, fill, name)
    for order in reversed(orders):
        out = out.transpose(np.argsort(order))
    return out


def _unshard(raw: bytes, config: dict, shape: Tuple[int, ...],
             dtype: np.dtype, fill, name: str) -> np.ndarray:
    """A ``sharding_indexed`` chunk of ``shape``: its inner chunks placed
    by the index (at the end or the start), each decoded by the inner
    codecs; an inner chunk not stored is ``fill``."""
    inner = tuple(config["chunk_shape"])
    if any(s % c for s, c in zip(shape, inner)) or len(inner) != len(shape):
        raise ValueError(f"{name}: inner chunks {list(inner)} do not tile "
                         f"the shard {list(shape)}")
    grid = tuple(s // c for s, c in zip(shape, inner))
    count = int(np.prod(grid))
    # The index's own encoding, whose byte count its codecs fix.
    index_codecs = config["index_codecs"]
    other = [c["name"] for c in index_codecs
             if c["name"] not in ("bytes", "crc32c")]
    if other:
        raise ValueError(f"{name}: shard index codecs {other} are not "
                         f"supported (bytes, crc32c)")
    size = 16 * count + 4 * sum(c["name"] == "crc32c" for c in index_codecs)
    at_end = config.get("index_location", "end") == "end"
    if len(raw) < size:
        raise ValueError(f"{name}: a shard of {len(raw)} bytes holds no "
                         f"index of {size}")
    index_raw = raw[len(raw) - size:] if at_end else raw[:size]
    index = _decode3(index_raw, index_codecs, grid + (2,),
                     np.dtype(np.uint64), 0, f"{name} (shard index)")
    out = np.empty(shape, dtype)
    out.fill(fill)
    for pos in np.ndindex(*grid) if grid else [()]:
        offset, nbytes = (int(v) for v in index[pos])
        if offset == _EMPTY and nbytes == _EMPTY:
            continue
        if offset + nbytes > len(raw):
            raise ValueError(f"{name}: inner chunk {pos} runs past the "
                             f"shard's {len(raw)} bytes")
        region = tuple(slice(i * c, (i + 1) * c) for i, c in zip(pos, inner))
        out[region] = _decode3(raw[offset:offset + nbytes],
                               config["codecs"], inner, dtype, fill, name)
    return out


def _read_array3(source: _Source, name: str, meta: dict):
    """One zarr v3 array (the module's docstring), all its chunks
    assembled."""
    if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
        raise ValueError(f"{name}: zarr.json is not a zarr v3 array")
    code = meta["data_type"]
    if code not in _DTYPES3:
        raise ValueError(f"{name}: zarr data type {code!r} is not "
                         f"supported")
    dtype = np.dtype(_DTYPES3[code])
    grid_meta = meta["chunk_grid"]
    if grid_meta.get("name") != "regular":
        raise ValueError(f"{name}: chunk grid {grid_meta.get('name')!r} is "
                         f"not supported")
    encoding = meta.get("chunk_key_encoding", {"name": "default"})
    kind = encoding.get("name")
    if kind not in ("default", "v2"):
        raise ValueError(f"{name}: chunk key encoding {kind!r} is not "
                         f"supported")
    sep = encoding.get("configuration", {}).get(
        "separator", "/" if kind == "default" else ".")
    shape = tuple(meta["shape"])
    chunks = tuple(grid_meta["configuration"]["chunk_shape"])
    fill = _fill3(meta, dtype, name)
    out = np.empty(shape, dtype)
    out.fill(fill)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid) if shape else [()]:
        coords = sep.join(map(str, index))
        key = (f"{name}/c{sep}{coords}" if index else f"{name}/c"
               ) if kind == "default" else f"{name}/{coords or '0'}"
        raw = source.get(key)
        if raw is None:
            continue
        chunk = _decode3(raw, meta["codecs"], chunks, dtype, fill, key)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return _bfloat16(out) if code == "bfloat16" else out


def _insert(tree, path: List[Tuple[str, int]], value) -> Any:
    """Put ``value`` at ``path`` ((key, key type) pairs) into ``tree``,
    creating dicts for dict keys and lists for sequence indices."""
    if not path:
        return value
    (key, kind), rest = path[0], path[1:]
    if kind == _KEY_SEQUENCE:
        tree = [] if tree is None else tree
        i = int(key)
        tree.extend([None] * (i + 1 - len(tree)))
        tree[i] = _insert(tree[i], rest, value)
    else:
        tree = {} if tree is None else tree
        tree[key] = _insert(tree.get(key), rest, value)
    return tree


def read_tree(root: str):
    """The tree of the Orbax checkpoint in ``root`` (see the module's
    docstring), zarr v2 or v3.  Raises ``ValueError`` for a pre-OCDBT
    msgpack tree, naming the route to convert it."""
    _check_format(root)
    with open(os.path.join(root, METADATA)) as f:
        meta = json.load(f)
    source = _Source(root, meta.get("use_ocdbt", True))
    tree = None
    for key_str, entry in sorted(meta["tree_metadata"].items(),
                                 key=lambda kv: ast.literal_eval(kv[0])):
        path = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        value_meta = entry["value_metadata"]
        kind = value_meta["value_type"]
        if value_meta.get("skip_deserialize") or kind in ("None", "Dict",
                                                           "List"):
            value = {"Dict": {}, "List": []}.get(kind)
        elif kind in ("jax.Array", "np.ndarray", "scalar"):
            value = _read_array(source, ".".join(k for k, _ in path))
            if kind == "scalar":
                if value.ndim:
                    raise ValueError(f"{root!r}: scalar {key_str} has "
                                     f"shape {value.shape}")
                value = value.item()
        else:
            raise ValueError(f"{root!r}: leaf {key_str} of kind {kind!r} "
                             f"is not supported")
        tree = _insert(tree, path, value)
    return {} if tree is None else tree


# ---- writing -------------------------------------------------------------

def _leaves(tree, path=()):
    """(key path as (key, key type) pairs, leaf) in Orbax's order; None and
    empty dicts or lists are leaves (Orbax records them and restores
    nothing)."""
    if isinstance(tree, dict) and tree:
        for key in sorted(tree):
            yield from _leaves(tree[key], path + ((str(key), _KEY_DICT),))
    elif isinstance(tree, (list, tuple)) and len(tree):
        for i, item in enumerate(tree):
            yield from _leaves(item, path + ((str(i), _KEY_SEQUENCE),))
    else:
        yield path, tree


def _array_bytes(leaf) -> Tuple[str, List[int], bytes]:
    """(zarr dtype, shape, C-order bytes) of an array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.int16).numpy(
                ).tobytes()
        leaf = t.numpy()
    arr = np.asarray(leaf)
    code = arr.dtype.str
    if code not in _DTYPES:
        raise ValueError(f"dtype {arr.dtype} cannot be written")
    return code, list(arr.shape), arr.tobytes()


def write_tree(root: str, tree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of numpy arrays,
    tensors and Python numbers; None and empty containers allowed) as an
    Orbax checkpoint in ``root``, replacing what is there: a directory
    written beside it, then renamed (as Orbax finalizes a save)."""
    root = os.path.abspath(root)
    tmp = f"{root}.orbax-checkpoint-tmp-{uuid.uuid4().hex[:12]}"
    os.makedirs(tmp)
    start = time.time_ns()
    items: Dict[str, bytes] = {}
    tree_meta, array_meta, sharding = {}, [], {}
    for path, leaf in _leaves(tree):
        keys = [k for k, _ in path]
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in path]}
        if leaf is None or isinstance(leaf, (dict, list, tuple)):
            kind = "None" if leaf is None else \
                ("Dict" if isinstance(leaf, dict) else "List")
            entry["value_metadata"] = {"value_type": kind,
                                       "skip_deserialize": True}
        else:
            name = ".".join(keys)
            scalar = isinstance(leaf, (bool, int, float, np.generic))
            code, shape, data = _array_bytes(leaf)
            items[f"{name}/.zarray"] = json.dumps({
                "chunks": [max(1, s) for s in shape], "compressor": None,
                "dimension_separator": ".", "dtype": code,
                "fill_value": None, "filters": None, "order": "C",
                "shape": shape, "zarr_format": 2}).encode()
            items[f"{name}/{'.'.join('0' * len(shape)) or '0'}"] = data
            # JAX holds 64-bit arrays only in its x64 mode: those stay
            # numpy arrays, as Orbax records a numpy leaf.
            kind = "scalar" if scalar else (
                "np.ndarray" if code in ("<f8", "<i8") else
                "jax.Array")
            entry["value_metadata"] = {"value_type": kind,
                                       "skip_deserialize": False}
            if kind == "jax.Array":
                entry["value_metadata"]["write_shape"] = shape
                array_meta.append({"array_metadata": {
                    "param_name": name, "write_shape": shape,
                    "chunk_shape": shape, "ext_metadata": None}})
                sharding[base64.b64encode(name.encode()).decode()] = \
                    json.dumps({"sharding_type": "SingleDeviceSharding",
                                "device_str": "TFRT_CPU_0"})
        tree_meta[str(tuple(keys))] = entry
    write_ocdbt(tmp, items)
    files = {
        METADATA: {"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None},
        "_sharding": sharding,
        os.path.join("array_metadatas", "process_0"):
            {"array_metadatas": array_meta},
        "_CHECKPOINT_METADATA": {
            "item_handlers": "orbax.checkpoint._src.handlers."
                             "standard_checkpoint_handler."
                             "StandardCheckpointHandler",
            "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": start,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}},
    }
    for name, content in files.items():
        os.makedirs(os.path.dirname(os.path.join(tmp, name)), exist_ok=True)
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(content, f)
    if os.path.isdir(root):
        shutil.rmtree(root)
    elif os.path.exists(root):
        os.remove(root)
    os.replace(tmp, root)
