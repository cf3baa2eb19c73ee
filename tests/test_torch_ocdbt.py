"""The port's OCDBT store (``utils/ocdbt.py``) against tensorstore's, on
the CPU.

* Stores tensorstore writes: the JAX package's Orbax fixture
  (``tests/data/orbax_jax_adam``: a height-0 root whose larger values lie
  in data files under ``ocdbt.process_0/``), a store of interior nodes
  (``max_decoded_node_bytes`` 200), one whose older versions went into
  version tree nodes (arity 2), and one of several versions. The port's
  manifest and every node it reaches equal ``tensorstore.ocdbt.dump``'s
  field for field, and ``read_store`` equals tensorstore's ``list()`` and
  ``read()`` of the newest version.
* The port's store (``write_store``) opened by tensorstore's ``ocdbt``
  driver: the same keys and values, and its manifest and root node as
  ``dump`` shows them equal the port's parse.
* CRC-32C against ``google_crc32c``; a missing manifest, a truncated or
  corrupted manifest or node and a short data file raise ``OcdbtError``
  (a ``ValueError``) naming the file.
"""

import os
import shutil

import google_crc32c
import pytest
import tensorstore as ts

from multimodalgame_tpu_torch.utils import ocdbt

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "orbax_jax_adam")


def _tensorstore_store(root, config, versions):
    """A store tensorstore writes at ``root``: ``versions`` commits of
    the given ``{key: value}`` maps."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    for items in versions:
        with ts.Transaction() as txn:
            for k, v in items.items():
                kv.with_transaction(txn)[k] = v
    return root


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("ocdbt")
    many = [{f"key{i:03d}/x": (b"v%d" % i) * (1 + i % 5)
             for i in range(40)}]
    return {
        "orbax_fixture": FIXTURE,
        "interior": _tensorstore_store(
            str(base / "interior"), {"max_inline_value_bytes": 8,
                                     "max_decoded_node_bytes": 200}, many),
        "version_tree": _tensorstore_store(
            str(base / "version_tree"), {"compression": None,
                                         "version_tree_arity_log2": 1},
            [{f"k{i}": b"v" * i} for i in range(6)]),
        "versions": _tensorstore_store(
            str(base / "versions"), {"max_inline_value_bytes": 4},
            [{"abc": b"xy"}, {"abd": b"0123456789"}, {"b": b"zz"},
             {"abc": b"overwritten value"}]),
    }


def _file_kv(root):
    return ts.KvStore.open({"driver": "file", "path": root + "/"}).result()


def _read_location(root, location):
    _, base, rel, off, length = location.split(":")
    with open(os.path.join(root, base + rel), "rb") as f:
        f.seek(int(off))
        return f.read(int(length))


NAMES = ["orbax_fixture", "interior", "version_tree", "versions"]


@pytest.mark.parametrize("name", NAMES)
def test_manifest_and_nodes_are_tensorstores(stores, name):
    root = stores[name]
    kv = _file_kv(root)
    with open(os.path.join(root, ocdbt.MANIFEST), "rb") as f:
        manifest = ocdbt.parse_manifest(f.read())
    assert manifest == ts.ocdbt.dump(kv).result()
    todo = [v["root"]["location"] for v in manifest["versions"]
            if "location" in v["root"]]
    seen = 0
    while todo:
        location = todo.pop()
        node = ocdbt.parse_node(_read_location(root, location), location)
        assert node == ts.ocdbt.dump(kv, location).result(), location
        todo += [e["location"] for e in node["entries"] if "location" in e]
        for e in node["entries"]:
            if "indirect_value" in e:
                assert _read_location(root, e["indirect_value"]) == \
                    ts.ocdbt.dump(kv, e["indirect_value"]).result()
        seen += 1
    assert seen >= 1


@pytest.mark.parametrize("name", NAMES)
def test_read_store_is_tensorstores(stores, name):
    root = stores[name]
    got = ocdbt.read_store(root)
    store = ts.KvStore.open({"driver": "ocdbt",
                             "base": f"file://{root}/"}).result()
    keys = store.list().result()
    assert sorted(got) == sorted(keys)
    for k in keys:
        assert got[k] == store.read(k).result().value, k


def test_port_store_read_by_tensorstore(tmp_path):
    items = {b"a/.zarray": b"{}", b"a/0": os.urandom(5000),
             b"b": b"x" * ocdbt.MAX_INLINE_VALUE_BYTES,
             b"c": b"y" * (ocdbt.MAX_INLINE_VALUE_BYTES + 1),
             b"": b"the empty key", b"a/1": b""}
    root = str(tmp_path / "port")
    ocdbt.write_store(root, items)
    store = ts.KvStore.open({"driver": "ocdbt",
                             "base": f"file://{root}/"}).result()
    keys = store.list().result()
    assert sorted(keys) == sorted(items)
    for k in keys:
        assert store.read(k).result().value == items[k], k
    assert ocdbt.read_store(root) == items
    kv = _file_kv(root)
    dumped = ts.ocdbt.dump(kv).result()
    with open(os.path.join(root, ocdbt.MANIFEST), "rb") as f:
        assert ocdbt.parse_manifest(f.read()) == dumped
    assert dumped["config"]["compression"] == {"id": "zstd"}
    assert (dumped["config"]["max_inline_value_bytes"],
            dumped["config"]["max_decoded_node_bytes"],
            dumped["config"]["version_tree_arity_log2"]) == (
                ocdbt.MAX_INLINE_VALUE_BYTES, ocdbt.MAX_DECODED_NODE_BYTES,
                ocdbt.ARITY_LOG2)
    location = dumped["versions"][-1]["root"]["location"]
    node = ts.ocdbt.dump(kv, location).result()
    assert node["height"] == 0
    assert ocdbt.parse_node(_read_location(root, location), location) == node
    inline = {e["key"] for e in node["entries"] if "inline_value" in e}
    assert inline == {k for k, v in items.items()
                      if len(v) <= ocdbt.MAX_INLINE_VALUE_BYTES}


@pytest.mark.parametrize("n", [0, 1, 5, 1000, 65536])
def test_crc32c_is_google_crc32c(n):
    data = os.urandom(n)
    assert ocdbt.crc32c(data) == google_crc32c.value(data)


def _damaged(tmp_path, name, edit):
    root = str(tmp_path / name)
    shutil.copytree(FIXTURE, root)
    edit(root)
    return root


def _manifest(root):
    return os.path.join(root, ocdbt.MANIFEST)


def _root_node_file(root):
    return os.path.join(root, "d", os.listdir(os.path.join(root, "d"))[0])


def _cut(path, keep):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:keep(len(data))])


def _flip(path, at):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[at(len(data))] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(data))


def _short_data_file(root):
    d = os.path.join(root, "ocdbt.process_0", "d")
    for name in os.listdir(d):
        _cut(os.path.join(d, name), lambda n: n // 2)


DAMAGE = {
    "no_manifest": (lambda r: os.remove(_manifest(r)), ocdbt.MANIFEST),
    "manifest_truncated": (lambda r: _cut(_manifest(r), lambda n: n - 9),
                           ocdbt.MANIFEST),
    "manifest_corrupt": (lambda r: _flip(_manifest(r), lambda n: n // 2),
                         "checksum"),
    "node_truncated": (lambda r: _cut(_root_node_file(r), lambda n: n - 1),
                       "runs past"),
    "node_corrupt": (lambda r: _flip(_root_node_file(r), lambda n: n - 40),
                     "checksum"),
    "data_file_short": (_short_data_file, "runs past"),
}


@pytest.mark.parametrize("case", list(DAMAGE))
def test_damaged_stores_raise_naming_the_file(tmp_path, case):
    edit, match = DAMAGE[case]
    root = _damaged(tmp_path, case, edit)
    with pytest.raises(ocdbt.OcdbtError, match=match) as err:
        ocdbt.read_store(root)
    assert root in str(err.value)
