"""tensorstore's OCDBT key-value store, read and written in pure Python.

An Orbax checkpoint keeps its arrays in an OCDBT ("optionally cooperative
distributed B+tree") database: a ``manifest.ocdbt`` file at the store's
root names the newest version's B+tree root, and the tree's nodes and its
larger values lie in data files under ``d/`` (Orbax's own store lists
data files under ``ocdbt.process_0/d/`` too: a data file's id carries its
base path). This module is the port's copy of that format, for machines
without ``tensorstore``.

Every encoded manifest and node is an envelope: a big-endian magic number
(:data:`MANIFEST_MAGIC`, :data:`NODE_MAGIC`), the little-endian uint64
length of the whole envelope, the format version (a varint, 0), the
compression (a varint: 0 none, 1 zstd), the body, and the CRC-32C of all
of it before the checksum, little-endian. Inside, integers are varints,
and arrays of records are stored a column at a time:

* a manifest's body: the config (a 16-byte uuid, manifest kind,
  ``max_inline_value_bytes``, ``max_decoded_node_bytes``, a byte
  ``version_tree_arity_log2``, the compression method and, for zstd, an
  int32 level), a data file table, the versions (generation number, root
  height, the root's location: data file id, offset, length; its
  statistics: keys, tree bytes, indirect value bytes; the commit time as
  a uint64 of nanoseconds) and the references to the version tree nodes
  that hold older versions (generation number, location, generation
  count, commit time, height);
* a data file table: the count, each path's prefix shared with the path
  before it, each path's suffix length and base path length, then the
  suffixes;
* a B+tree node's body: its height, a data file table and its entries:
  keys prefix-compressed against the entry before, then for a leaf each
  value's length and kind (0 inline, 1 indirect), the indirect values'
  data file ids and offsets, and the inline values; for an interior node
  each entry's subtree common prefix length and its child's location and
  statistics. A child's keys are stored without the prefix its parent
  entry names.

:func:`read_store` maps each key of the newest version to its value.
:func:`write_store` writes one version: values longer than
``max_inline_value_bytes`` in one data file, followed there by the one
leaf that holds every key, under JAX's config (zstd, 1024, 100000000,
arity 4). Bytes that are not such a store raise :class:`OcdbtError`, a
``ValueError`` naming the file.
"""

from __future__ import annotations

import os
import secrets
import struct
import time
from typing import Dict, List, Tuple

from multimodalgame_tpu_torch.utils import zstd

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
# JAX's store: tensorstore's defaults as Orbax opens them.
MAX_INLINE_VALUE_BYTES, MAX_DECODED_NODE_BYTES, ARITY_LOG2 = (
    1024, 100_000_000, 4)
_MISSING = (1 << 64) - 1          # the offset and length of no location


class OcdbtError(ValueError):
    """Bytes that are not an OCDBT store."""


# -------------------------------------------------------------- CRC-32C

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of every envelope."""
    c = 0xFFFFFFFF
    table = _CRC
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ------------------------------------------------------------- decoding

class _Reader:
    """A cursor over a body; reads past its end raise."""

    __slots__ = ("buf", "pos", "where")

    def __init__(self, buf: bytes, where: str):
        self.buf, self.pos, self.where = buf, 0, where

    def fail(self, what: str) -> OcdbtError:
        return OcdbtError(f"{self.where}: {what}")

    def varint(self) -> int:
        v = shift = 0
        buf, pos = self.buf, self.pos
        while True:
            if pos >= len(buf):
                raise self.fail("truncated")
            b = buf[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                raise self.fail("a varint is too long")
        self.pos = pos
        return v

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise self.fail("truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise self.fail(f"{len(self.buf) - self.pos} bytes left over")


def open_envelope(data: bytes, magic: int, where: str) -> bytes:
    """The body of an envelope, its checksum checked and decompressed."""
    if len(data) < 18:
        raise OcdbtError(f"{where}: truncated ({len(data)} bytes)")
    (got,) = struct.unpack_from(">I", data, 0)
    if got != magic:
        raise OcdbtError(f"{where}: magic 0x{got:08x}, not 0x{magic:08x}")
    (length,) = struct.unpack_from("<Q", data, 4)
    if length != len(data):
        raise OcdbtError(f"{where}: {len(data)} bytes, its header says "
                         f"{length}")
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    if crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{where}: checksum mismatch")
    r = _Reader(data[:-4], where)
    r.pos = 12
    if r.varint() != 0:
        raise r.fail("unknown format version")
    compression = r.varint()
    body = data[r.pos:-4]
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{where}: {e}") from None
    if compression != 0:
        raise r.fail(f"unknown compression {compression}")
    return body


def _file_table(r: _Reader) -> List[Tuple[str, str]]:
    """A data file table: ``[(base path, relative path)]``."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise r.fail("a data file path's prefix is too long")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(full):
            raise r.fail("a data file's base path is too long")
        try:
            files.append((full[:base[i]].decode(), full[base[i]:].decode()))
        except UnicodeDecodeError:
            raise r.fail("a data file path is not UTF-8") from None
        prev = full
    return files


def _location(kind: str, files, fid: int, offset: int, length: int,
              r: _Reader) -> str:
    if fid >= len(files):
        raise r.fail(f"data file id {fid} outside its table")
    base, rel = files[fid]
    return f"{kind}:{base}:{rel}:{offset}:{length}"


def parse_manifest(data: bytes, where: str = MANIFEST) -> dict:
    """A manifest as ``tensorstore.ocdbt.dump`` shows it (the versions'
    ``root`` with a ``location`` string where the tree is not empty)."""
    r = _Reader(open_envelope(data, MANIFEST_MAGIC, where), where)
    uuid = r.take(16).hex()
    kind = r.varint()
    config = {"max_inline_value_bytes": r.varint(),
              "max_decoded_node_bytes": r.varint(),
              "version_tree_arity_log2": r.byte(), "uuid": uuid}
    method = r.varint()
    if method == 1:
        (level,) = struct.unpack("<i", r.take(4))
        config["compression"] = ({"id": "zstd"} if level == 0
                                 else {"id": "zstd", "level": level})
    elif method == 0:
        config["compression"] = None
    else:
        raise r.fail(f"unknown compression method {method}")
    if kind != 0:
        raise r.fail("a numbered manifest: the port reads single-file "
                     "manifests, which Orbax writes")
    files = _file_table(r)
    n = r.varint()
    gen, height = r.varints(n), [r.byte() for _ in range(n)]
    fid, off, length = r.varints(n), r.varints(n), r.varints(n)
    keys, tree, indirect = r.varints(n), r.varints(n), r.varints(n)
    commit = [struct.unpack("<Q", r.take(8))[0] for _ in range(n)]
    versions = []
    for i in range(n):
        root = {"statistics": {"num_indirect_value_bytes": indirect[i],
                               "num_keys": keys[i],
                               "num_tree_bytes": tree[i]}}
        if off[i] != _MISSING:
            root["location"] = _location("btreenode", files, fid[i], off[i],
                                         length[i], r)
        versions.append({"commit_time": commit[i], "generation_number":
                         gen[i], "root": root, "root_height": height[i]})
    # Older versions' tree nodes: the newest version is always inline.
    n = r.varint()
    gen, fid, off, length = (r.varints(n), r.varints(n), r.varints(n),
                             r.varints(n))
    ngen = r.varints(n)
    commit = [struct.unpack("<Q", r.take(8))[0] for _ in range(n)]
    height = [r.byte() for _ in range(n)]
    r.done()
    nodes = [{"commit_time": commit[i], "generation_number": gen[i],
              "height": height[i], "location": _location(
                  "versionnode", files, fid[i], off[i], length[i], r),
              "num_generations": ngen[i]} for i in range(n)]
    return {"config": config, "version_tree_nodes": nodes,
            "versions": versions}


def parse_node(data: bytes, where: str) -> dict:
    """A B+tree node as ``tensorstore.ocdbt.dump`` shows it: keys relative
    to the prefix its parent names, values inline or ``value:`` locations,
    children ``btreenode:`` locations with their statistics."""
    r = _Reader(open_envelope(data, NODE_MAGIC, where), where)
    height = r.byte()
    files = _file_table(r)
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if height else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise r.fail("a key's prefix is too long")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    entries = []
    if height:
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        nkeys, tree, indirect = r.varints(n), r.varints(n), r.varints(n)
        for i in range(n):
            if common[i] > len(keys[i]):
                raise r.fail("a subtree prefix is longer than its key")
            entries.append({
                "key": keys[i],
                "location": _location("btreenode", files, fid[i], off[i],
                                      length[i], r),
                "statistics": {"num_indirect_value_bytes": indirect[i],
                               "num_keys": nkeys[i],
                               "num_tree_bytes": tree[i]},
                "subtree_common_prefix": keys[i][:common[i]]})
    else:
        lengths, kinds = r.varints(n), r.varints(n)
        if any(k > 1 for k in kinds):
            raise r.fail("unknown value kind")
        m = sum(kinds)
        fid, off = r.varints(m), r.varints(m)
        j = 0
        for i in range(n):
            if kinds[i]:
                entries.append({"indirect_value": _location(
                    "value", files, fid[j], off[j], lengths[i], r),
                    "key": keys[i]})
                j += 1
            else:
                entries.append({"inline_value": r.take(lengths[i]),
                                "key": keys[i]})
    r.done()
    return {"entries": entries, "height": height}


class _Files:
    """The store's files, each read once."""

    def __init__(self, root: str):
        self.root, self.cache = root, {}

    def read(self, location: str) -> Tuple[bytes, str]:
        _, base, rel, off, length = location.split(":")
        name = os.path.join(self.root, base + rel)
        if name not in self.cache:
            try:
                with open(name, "rb") as f:
                    self.cache[name] = f.read()
            except OSError as e:
                raise OcdbtError(f"{name}: {e.strerror}") from None
        data = self.cache[name]
        off, length = int(off), int(length)
        if off + length > len(data):
            raise OcdbtError(f"{name}: [{off}, {off + length}) runs past "
                             f"its {len(data)} bytes")
        return data[off:off + length], f"{name}@{off}"


def read_store(root: str) -> Dict[bytes, bytes]:
    """Every key of the newest version of the store at ``root`` with its
    value."""
    path = os.path.join(root, MANIFEST)
    try:
        with open(path, "rb") as f:
            manifest = parse_manifest(f.read(), path)
    except OSError as e:
        raise OcdbtError(f"{path}: {e.strerror}") from None
    if not manifest["versions"]:
        raise OcdbtError(f"{path}: no version")
    version = manifest["versions"][-1]
    files, out = _Files(root), {}
    if "location" not in version["root"]:
        return out
    stack = [(version["root"]["location"], b"", version["root_height"])]
    while stack:
        location, prefix, height = stack.pop()
        data, where = files.read(location)
        node = parse_node(data, where)
        if node["height"] != height:
            raise OcdbtError(f"{where}: height {node['height']}, its "
                             f"parent says {height}")
        for e in node["entries"]:
            if height:
                stack.append((e["location"],
                              prefix + e["subtree_common_prefix"],
                              height - 1))
            elif "inline_value" in e:
                out[prefix + e["key"]] = e["inline_value"]
            else:
                out[prefix + e["key"]] = files.read(e["indirect_value"])[0]
    if len(out) != version["root"]["statistics"]["num_keys"]:
        raise OcdbtError(f"{path}: {len(out)} keys, the manifest says "
                         f"{version['root']['statistics']['num_keys']}")
    return out


# ------------------------------------------------------------- encoding

def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vals) -> bytes:
    return b"".join(_varint(v) for v in vals)


def seal_envelope(body: bytes, magic: int) -> bytes:
    """``body`` in an envelope, zstd-compressed (JAX's config)."""
    payload = zstd.compress(body)
    n = 4 + 8 + 1 + 1 + len(payload) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", n) + b"\x00\x01"
    data = head + payload
    return data + struct.pack("<I", crc32c(data))


def _one_file_table(rel: str) -> bytes:
    path = rel.encode()
    return _varint(1) + _varint(len(path)) + _varint(0) + path


def _shared(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def write_store(root: str, items: Dict[bytes, bytes]) -> None:
    """A store at ``root`` (created) holding ``items`` as its one
    version."""
    keys = sorted(items)
    if not keys:
        raise OcdbtError(f"{root}: a store needs at least one key")
    rel = "d/" + secrets.token_hex(16)
    values, lengths, kinds, offsets, inline = [], [], [], [], []
    pos = 0
    for k in keys:
        v = items[k]
        lengths.append(len(v))
        if len(v) > MAX_INLINE_VALUE_BYTES:
            kinds.append(1)
            offsets.append(pos)
            values.append(v)
            pos += len(v)
        else:
            kinds.append(0)
            inline.append(v)
    prefix = [_shared(a, b) for a, b in zip(keys, keys[1:])]
    body = b"".join([
        b"\x00", _one_file_table(rel), _varint(len(keys)), _varints(prefix),
        _varints(len(k) - p for k, p in zip(keys, [0] + prefix)),
        b"".join(k[p:] for k, p in zip(keys, [0] + prefix)),
        _varints(lengths), _varints(kinds), _varints([0] * len(offsets)),
        _varints(offsets), b"".join(inline)])
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise OcdbtError(f"{root}: {len(keys)} keys need {len(body)} bytes "
                         "of leaf, over max_decoded_node_bytes")
    node = seal_envelope(body, NODE_MAGIC)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, rel), "wb") as f:
        f.writelines(values)
        f.write(node)
    config = b"".join([
        secrets.token_bytes(16), _varint(0),
        _varint(MAX_INLINE_VALUE_BYTES), _varint(MAX_DECODED_NODE_BYTES),
        bytes([ARITY_LOG2]), _varint(1), struct.pack("<i", 0)])
    versions = b"".join([
        _varint(1), _varint(1), b"\x00", _varint(0), _varint(pos),
        _varint(len(node)), _varint(len(keys)), _varint(len(node)),
        _varint(pos), struct.pack("<Q", time.time_ns()), _varint(0)])
    manifest = seal_envelope(config + _one_file_table(rel) + versions,
                             MANIFEST_MAGIC)
    with open(os.path.join(root, MANIFEST), "wb") as f:
        f.write(manifest)
