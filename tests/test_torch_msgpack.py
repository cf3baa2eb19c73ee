"""The port's msgpack codec (``utils/msgpack.py``) against flax's, on the
CPU: for each case, the port decodes flax's ``msgpack_serialize`` bytes
to the tree flax's ``msgpack_restore`` gives (the same types, arrays of
the same dtype, shape and values), the port's encoder writes flax's bytes
(so they decode under flax to an equal tree), and every truncation of the
bytes raises ``MsgpackError`` (a ``ValueError``). Chunked leaves are made
by lowering both packages' ``MAX_CHUNK_SIZE``."""

import jax
import numpy as np
import pytest
from flax import serialization

from multimodalgame_tpu.game.agents import AgentModules as JaxModules
from multimodalgame_tpu.game.agents import init_params as jax_init_params
from multimodalgame_tpu.game.config import GameConfig as JaxConfig
from multimodalgame_tpu.game.train import (
    init_opt_states as jax_init_opt_states)
from multimodalgame_tpu_torch.utils import msgpack

RNG = np.random.RandomState(0)
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
        -2 ** 31 - 1, -2 ** 63]


def _checkpoint_payload():
    """The payload JAX's ``save_checkpoint`` writes for a small Adam game
    (its ``_payload``: 0-d data arrays, flax state dicts)."""
    cfg = JaxConfig(img_feat_dim=24, img_h_dim=12, sender_out_dim=10,
                    rec_w_dim=10, rec_hidden=14, wv_dim=16, max_exchange=4,
                    baseline_hid_dim=12, optim_type="Adam")
    params = jax_init_params(JaxModules(cfg), jax.random.PRNGKey(0),
                             num_classes=5)
    opts = jax_init_opt_states(cfg, params)
    return {"data": {"step": np.asarray(3), "best_dev_acc": np.asarray(0.5),
                     "final_dev_acc": np.asarray(0.25)},
            "models": serialization.to_state_dict(
                jax.device_get(params)),
            "optimizers": serialization.to_state_dict(
                jax.device_get(opts))}


CASES = {
    "nil_bool_float": lambda: {"n": None, "t": True, "f": False,
                               "x": 1.5, "y": -0.0, "z": 1e300},
    "ints_every_width": lambda: {"ints": INTS},
    "str_and_bin_every_length": lambda: {
        "s": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "b": [b"", b"x" * 255, b"y" * 256, b"z" * 70000]},
    "arrays_and_maps_every_length": lambda: {
        "l15": list(range(15)), "l16": list(range(16)),
        "m15": {f"k{i:02d}": i for i in range(15)},
        "m16": {f"k{i:02d}": i for i in range(16)},
        "big": {f"k{i:05d}": [] for i in range(70000)}},
    "empty_maps": lambda: {"a": {}, "b": {"c": {}, "d": {"e": {}}}, "f": []},
    "zero_d_arrays": lambda: {
        "i32": np.asarray(3, np.int32), "i64": np.asarray(-2 ** 40),
        "f32": np.asarray(0.25, np.float32), "f64": np.asarray(0.1)},
    "arrays_of_every_dtype": lambda: {
        str(dt): RNG.randn(2, 3, 4).astype(dt)
        for dt in (np.float16, np.float32, np.float64, np.int8, np.int16,
                   np.int32, np.int64, np.uint8, np.uint16, np.uint32,
                   np.uint64, np.bool_, np.complex64, np.complex128)},
    "array_shapes": lambda: {
        "empty": np.zeros((0, 3), np.float32), "one": np.ones(1),
        "wide": RNG.randn(1, 70000).astype(np.float32),
        "fixext_sizes": [np.zeros(n, np.uint8) for n in range(0, 20)]},
    "ext2_complex": lambda: {"c": complex(1.5, -2.0), "l": [1j, 0j]},
    "ext3_numpy_scalars": lambda: {
        "f64": np.float64(3.0), "f32": np.float32(-1.25),
        "i32": np.int32(7), "b": np.bool_(True), "u8": np.uint8(200)},
    "jax_checkpoint_payload": _checkpoint_payload,
    "chunked_leaves": lambda: {
        "w": RNG.randn(10, 7).astype(np.float32),
        "nested": {"i": np.arange(50), "small": np.zeros(2, np.float32)},
        "in_list": [np.arange(40)]},
}


def _assert_same(got, want, where="tree"):
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, np.generic):
        assert got.dtype == want.dtype and got == want, where
    else:
        assert got == want or (got != got and want != want), where


@pytest.mark.parametrize("case", list(CASES))
def test_codec_against_flax(case, monkeypatch):
    if case == "chunked_leaves":
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = CASES[case]()
    blob = serialization.msgpack_serialize(tree)
    if case == "chunked_leaves":
        assert blob.count(msgpack.CHUNKED.encode()) == 2   # not in a list
    # The port's decoder gives flax's tree.
    _assert_same(msgpack.unpackb(blob), serialization.msgpack_restore(blob))
    # The port's encoder writes flax's bytes: they decode under flax to
    # the tree flax's own bytes give.
    mine = msgpack.packb(tree)
    assert mine == blob
    _assert_same(serialization.msgpack_restore(mine),
                 serialization.msgpack_restore(blob))
    # A truncated file raises, wherever it was cut.
    for n in sorted({0, 1, 2, len(blob) // 3, len(blob) // 2,
                     len(blob) - 1}):
        with pytest.raises(msgpack.MsgpackError):
            msgpack.unpackb(blob[:n])


@pytest.mark.parametrize("blob,match", [
    (b"\xc1", "starts no msgpack"),                    # never used
    (b"\x81\x01\x02", "map key"),                      # an int key
    (b"\xd4\x07\x00", "ext type 7"),                   # not flax's
    (b"\x80\x80", "after the object"),                 # trailing bytes
    (b"\xa2\xff\xfe", "not UTF-8"),
    (msgpack.packb({"x": np.zeros(2)}).replace(b"float64", b"floatxx"),
     "dtype 'floatxx'"),
    (msgpack.packb({"x": np.zeros(2)}).replace(b"float64", b"float32"),
     "holds 16 bytes"),
], ids=["reserved_byte", "int_map_key", "unknown_ext", "trailing",
        "bad_utf8", "unknown_dtype", "wrong_size"])
def test_malformed_bytes_raise(blob, match):
    with pytest.raises(msgpack.MsgpackError, match=match):
        msgpack.unpackb(blob)
