"""Orbax PyTree checkpoint directories, read and written without Orbax.

The JAX package's ``-ckpt_format orbax`` writes its ``{data, models,
optimizers}`` tree with Orbax's ``PyTreeCheckpointHandler``. Such a
directory holds three layers, each of which the port reads and writes
with its own code:

* ``_METADATA``: JSON whose ``tree_metadata`` names every leaf by its key
  path (``"('models', 'sender', 'code_bias')"``, with ``key_metadata``
  listing the keys), an array as ``value_type`` ``np.ndarray`` and an
  empty dict (the optax chain's empty states) as ``Dict`` with
  ``skip_deserialize``; the flags ``use_ocdbt`` (true) and ``use_zarr3``
  (false); ``_CHECKPOINT_METADATA``: the handler's name and the init and
  commit times;
* one OCDBT store at the directory's root (``utils/ocdbt.py``), holding
  each array as a zarr v2 array named by its keys joined with ``.``;
* zarr v2: ``<name>/.zarray`` (shape, chunk shape, dtype, ``C`` order,
  compressor ``{"id": "zstd", "level": 1}``, ``.`` between chunk
  indices) and one key per chunk, ``<name>/<i.j...>`` (``0`` for a
  0-d array), each chunk the zstd frame (``utils/zstd.py``) of the whole
  chunk shape's bytes, edge chunks padded.

:func:`read_orbax` returns the nested dict of numpy arrays that
``utils/msgpack.py:unpackb`` returns for the same state, empty dicts
included. :func:`write_orbax` writes the directory JAX's Orbax writes for
the same tree (the same ``_METADATA`` and ``.zarray`` JSON; every array
one chunk, as Orbax chooses below 2 GiB a leaf), through a temporary
sibling renamed when complete, so a crash never leaves half a directory
at the path. A directory that is not such a checkpoint raises
:class:`OrbaxError`, a ``ValueError`` naming it.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from multimodalgame_tpu_torch.utils import ocdbt, zstd

METADATA, CHECKPOINT_METADATA = "_METADATA", "_CHECKPOINT_METADATA"
TMP_INFIX = ".orbax-checkpoint-tmp-"     # Orbax's name for an uncommitted dir
HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
           "PyTreeCheckpointHandler")
COMPRESSOR = {"id": "zstd", "level": 1}
MAX_CHUNK_BYTES = 2 ** 31    # Orbax splits a leaf above OCDBT's file target


class OrbaxError(ValueError):
    """A directory that is not an Orbax checkpoint the port reads."""


def _dtype(name: str, where: str) -> np.dtype:
    try:
        dt = np.dtype(name)
    except TypeError:
        raise OrbaxError(f"{where}: dtype {name!r} has no numpy "
                         "equivalent") from None
    if dt.kind not in "biuf":
        raise OrbaxError(f"{where}: dtype {name!r} is not a number type")
    return dt


def _read_array(store: Dict[bytes, bytes], name: str,
                where: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``."""
    where = f"{where}: array {name}"
    raw = store.get(f"{name}/.zarray".encode())
    if raw is None:
        raise OrbaxError(f"{where} has no .zarray")
    try:
        meta = json.loads(raw)
        shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
        dtype_name = meta["dtype"]
    except (ValueError, KeyError, TypeError) as e:
        raise OrbaxError(f"{where}: malformed .zarray ({e!r})") from None
    dt = _dtype(dtype_name, where)
    if (meta.get("zarr_format") != 2 or meta.get("order") != "C"
            or meta.get("filters") or len(shape) != len(chunks)
            or any(c < 1 for c in chunks)
            or meta.get("dimension_separator", ".") != "."
            or (meta.get("compressor") or {}).get("id") != "zstd"):
        raise OrbaxError(f"{where}: a zarr v2 layout JAX's Orbax does not "
                         f"write: {meta}")
    out = np.empty(shape, dt.newbyteorder("="))
    nbytes = int(np.prod(chunks)) * dt.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*map(range, grid)):
        key = ".".join(map(str, idx)) if shape else "0"
        data = store.get(f"{name}/{key}".encode())
        if data is None:
            raise OrbaxError(f"{where}: chunk {key} is missing")
        try:
            data = zstd.decompress(data)
        except zstd.ZstdError as e:
            raise OrbaxError(f"{where}: chunk {key}: {e}") from None
        if len(data) != nbytes:
            raise OrbaxError(f"{where}: chunk {key} holds {len(data)} "
                             f"bytes, its shape {chunks} needs {nbytes}")
        chunk = np.frombuffer(data, dt).reshape(chunks)
        box = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[box] = chunk[tuple(slice(0, b.stop - b.start) for b in box)]
    return out


def _read_json(path: str, where: str) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except OSError as e:
        raise OrbaxError(f"{where}: {os.path.basename(path)}: "
                         f"{e.strerror}") from None
    except ValueError as e:
        raise OrbaxError(f"{where}: {os.path.basename(path)} is not "
                         f"JSON ({e})") from None


def read_orbax(path: str) -> Dict[str, Any]:
    """The tree of the Orbax checkpoint directory at ``path``."""
    if not os.path.isdir(path):
        raise OrbaxError(f"{path} is not a directory")
    meta = _read_json(os.path.join(path, METADATA), path)
    try:
        leaves = meta["tree_metadata"]
        ocdbt_layout, zarr3 = meta["use_ocdbt"], meta["use_zarr3"]
    except (KeyError, TypeError):
        raise OrbaxError(f"{path}: {METADATA} lacks tree_metadata, "
                         "use_ocdbt or use_zarr3") from None
    if not ocdbt_layout or zarr3:
        raise OrbaxError(f"{path}: use_ocdbt={ocdbt_layout}, use_zarr3="
                         f"{zarr3}; the port reads OCDBT and zarr v2, as "
                         "JAX writes them")
    store = ocdbt.read_store(path)
    tree: Dict[str, Any] = {}
    for name, leaf in leaves.items():
        try:
            keys = [str(k["key"]) for k in leaf["key_metadata"]]
            kind = leaf["value_metadata"]["value_type"]
            skip = leaf["value_metadata"].get("skip_deserialize", False)
        except (KeyError, TypeError):
            raise OrbaxError(f"{path}: {METADATA} entry {name} is "
                             "malformed") from None
        if kind == "Dict" and skip:
            value: Any = {}
        elif kind == "np.ndarray":
            value = _read_array(store, ".".join(keys), path)
        else:
            raise OrbaxError(f"{path}: {name} is a {kind}; the port reads "
                             "arrays and empty dicts")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise OrbaxError(f"{path}: {name} is under a leaf")
        if not keys or keys[-1] in node:
            raise OrbaxError(f"{path}: {name} is named twice")
        node[keys[-1]] = value
    return tree


def _leaves(tree: Dict[str, Any], keys: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(key path, array or None for an empty dict)`` in JAX's order
    (sorted keys, as ``jax.tree_util`` flattens a dict)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, keys + (k,)) if v else [(keys + (k,), None)]
        else:
            out.append((keys + (k,), np.asarray(v)))
    return out


def zarray(a: np.ndarray) -> Dict[str, Any]:
    """The ``.zarray`` Orbax writes for the array ``a``."""
    if a.nbytes > MAX_CHUNK_BYTES:
        raise OrbaxError(f"a {a.shape} leaf exceeds the 2 GiB Orbax writes "
                         "as one chunk")
    return {"chunks": [max(1, d) for d in a.shape],
            "compressor": COMPRESSOR, "dimension_separator": ".",
            "dtype": a.dtype.str, "fill_value": None, "filters": None,
            "order": "C", "shape": list(a.shape), "zarr_format": 2}


def write_orbax(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` (nested dicts of numpy arrays) as an Orbax
    checkpoint directory at ``path``, which must not exist."""
    init = time.time_ns()
    items, entries = {}, {}
    for keys, a in _leaves(tree):
        entries[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "Dict" if a is None
                               else "np.ndarray",
                               "skip_deserialize": a is None}}
        if a is None:
            continue
        if a.dtype.kind not in "biuf":
            raise OrbaxError(f"{path}: {keys} has dtype {a.dtype}")
        a = np.asarray(a, a.dtype.newbyteorder("<"), order="C")
        name = ".".join(keys)
        items[f"{name}/.zarray".encode()] = json.dumps(
            zarray(a), sort_keys=True, separators=(",", ":")).encode()
        if a.size:
            chunk = ".".join("0" * a.ndim) if a.ndim else "0"
            items[f"{name}/{chunk}".encode()] = zstd.compress(a.tobytes())
    meta = {"tree_metadata": entries, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    tmp = f"{path}{TMP_INFIX}{init}"
    os.makedirs(tmp)
    ocdbt.write_store(tmp, items)
    with open(os.path.join(tmp, METADATA), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": init,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    os.rename(tmp, path)
