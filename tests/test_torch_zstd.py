"""The port's zstd codec (``utils/zstd.py``) against tensorstore's and
zstandard's frames, on the CPU.

* Frames tensorstore writes as zarr chunks (``{"id": "zstd", "level":
  L}`` for L = 1, 3, 19, read back from a ``memory://`` kvstore) of random
  bytes, float32 weights, runs, text, a zero array and more than 128 KiB:
  the port decodes each to the array's bytes.
* A corpus of tensorstore and zstandard frames, with a few frames built
  by hand (RLE literals; every sequence table in RLE mode), reaches
  every part of the decoder: raw, RLE, Huffman (1 and 4 streams, 3-, 4-
  and 5-byte headers) and treeless literals, direct and FSE-compressed
  Huffman weights, and predefined, RLE, FSE and repeat tables for each
  of the three sequence codes.
* zstandard's frames with the XXH64 checksum, several frames and a
  skippable frame in one buffer; the port's XXH64 against ``xxhash``.
* Every truncation of a frame, a flipped byte of a checksummed frame, a
  dictionary frame and bytes that are no frame raise ``ZstdError`` (a
  ``ValueError``).
* The port's own frames (raw and RLE blocks) read by tensorstore and
  zstandard.
* ``tests/data/zstd_weights_level1.zst`` (tensorstore's level-1 frame of
  a seeded 256 x 100 float32 weight matrix, one compressed block, which
  chip_smoke.py times the decoder on) decodes to that matrix.
"""

import collections
import os

import numpy as np
import pytest
import tensorstore as ts
import xxhash
import zstandard

from multimodalgame_tpu_torch.utils import zstd

RNG = np.random.RandomState(0)


def _cases():
    rng = np.random.RandomState(0)
    return {
        "random": rng.randint(0, 256, 5000).astype(np.uint8),
        "floats": rng.randn(120, 100).astype(np.float32),
        "runs": np.repeat(rng.randint(0, 4, 300),
                          rng.randint(1, 200, 300)).astype(np.uint8),
        "text": np.frombuffer((b"the quick brown fox jumps over the lazy "
                               b"dog. " * 50 + bytes(range(256))) * 20,
                              np.uint8),
        "over_128k": np.concatenate([
            rng.randn(40000).astype(np.float32).view(np.uint8),
            np.zeros(10000, np.uint8),
            np.frombuffer(b"abcabcabd" * 1500, np.uint8)]),
        "zeros": np.zeros(1000, np.float32),
    }


CASES = _cases()


def tensorstore_frame(arr: np.ndarray, level: int) -> bytes:
    """The chunk tensorstore writes for ``arr`` as a one-chunk zarr v2
    array with ``{"id": "zstd", "level": level}``."""
    t = ts.open({"driver": "zarr",
                 "kvstore": {"driver": "memory", "path": "a/"},
                 "metadata": {"compressor": {"id": "zstd", "level": level},
                              "shape": list(arr.shape),
                              "chunks": list(arr.shape),
                              "dtype": arr.dtype.str},
                 "create": True}).result()
    t.write(arr).result()
    keys = [k for k in t.kvstore.list().result()
            if not k.endswith(b".zarray")]
    assert len(keys) == 1
    return t.kvstore.read(keys[0]).result().value


def block_kinds(frame: bytes) -> list:
    """The types of the blocks of a frame without dictionary or
    checksum flags (0 raw, 1 RLE, 2 compressed)."""
    fhd = frame[4]
    pos = 5 + (0 if fhd & 0x20 else 1)
    pos += ((1 if fhd & 0x20 else 0), 2, 4, 8)[fhd >> 6]
    kinds = []
    while True:
        head = int.from_bytes(frame[pos:pos + 3], "little")
        kinds.append((head >> 1) & 3)
        pos += 3 + (1 if kinds[-1] == 1 else head >> 3)
        if head & 1:
            return kinds


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", list(CASES))
def test_tensorstore_frames_decode(name, level):
    arr = CASES[name]
    frame = tensorstore_frame(arr, level)
    assert zstd.decompress(frame) == arr.tobytes()
    if name != "random":
        assert 2 in block_kinds(frame), "expected a compressed block"


def _hand_frames():
    """Frames built by hand for parts of the format zstd's own encoder
    rarely emits; each is checked against zstandard's decoder."""
    def frame(blocks):
        return (zstd.MAGIC.to_bytes(4, "little") + bytes([0])   # no FCS
                + bytes([0x58]) + blocks)                        # window

    def block(body, last=1):
        return (last | 2 << 1 | len(body) << 3).to_bytes(3, "little") + body
    # RLE literals: 20 times "q", then no sequences.
    rle_lits = frame(block(bytes([20 << 3 | 1, ord("q"), 0])))
    # Raw literals "abcd", one sequence with all three tables in RLE mode:
    # LL code 4, OF code 2 (offset value 4 + 3 = 7, offset 4), ML code 0
    # (length 3); the bitstream holds the offset's 2 extra bits (3) under
    # the end marker.
    rle_seq = frame(block(bytes([4 << 3]) + b"abcd"
                          + bytes([1, 0b01010100, 4, 2, 0, 0b111])))
    return {"rle_literals": (rle_lits, b"q" * 20),
            "rle_sequences": (rle_seq, b"abcdabc")}


def _corpus():
    rng = np.random.RandomState(1)
    out = [tensorstore_frame(a, lv) for a in CASES.values()
           for lv in (1, 3, 19)]
    letters = b"abcdefghijklmnop"
    extra = [bytes(rng.choice(list(letters), 400000).tolist()),
             bytes(rng.choice(list(letters), 10000).tolist()),
             b"".join([b"alpha ", b"beta ", b"gamma ", b"delta "][i]
                      for i in rng.randint(0, 4, 30000)),
             b"".join(b"x" + bytes(rng.choice(list(b"0123456789"),
                                              12).tolist()) * 2
                      for _ in range(3000))]
    extra += [a.tobytes() for a in CASES.values()]
    for data in extra:
        for lv in (1, 9, 19):
            out.append(zstandard.ZstdCompressor(level=lv).compress(data))
    return out


def test_corpus_reaches_every_part_of_the_decoder(monkeypatch):
    hits = collections.Counter()
    lit, weights, seq = zstd._literals, zstd._huffman_weights, \
        zstd._sequences

    def spy_literals(buf, pos, end, st):
        kind, fmt = buf[pos] & 3, (buf[pos] >> 2) & 3
        hits["literals", kind, fmt if kind >= 2 else None] += 1
        return lit(buf, pos, end, st)

    def spy_weights(buf, pos, end):
        hits["weights", "direct" if buf[pos] >= 128 else "fse"] += 1
        return weights(buf, pos, end)

    def spy_sequences(buf, pos, end, st, lits, out):
        b0 = buf[pos]
        if b0:
            modes = buf[pos + (1 if b0 < 128 else 2 if b0 < 255 else 3)]
            for i, code in enumerate(("LL", "OF", "ML")):
                hits["table", code, (modes >> (6 - 2 * i)) & 3] += 1
        return seq(buf, pos, end, st, lits, out)

    monkeypatch.setattr(zstd, "_literals", spy_literals)
    monkeypatch.setattr(zstd, "_huffman_weights", spy_weights)
    monkeypatch.setattr(zstd, "_sequences", spy_sequences)
    for frame in _corpus():
        want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
        assert zstd.decompress(frame) == want
    for frame, want in _hand_frames().values():
        assert zstandard.ZstdDecompressor().decompressobj().decompress(
            frame) == want
        assert zstd.decompress(frame) == want
    need = [("literals", 0, None), ("literals", 1, None),
            ("literals", 2, 0), ("literals", 2, 1), ("literals", 2, 2),
            ("literals", 2, 3), ("literals", 3, 2), ("literals", 3, 3),
            ("weights", "direct"), ("weights", "fse")]
    need += [("table", c, m) for c in ("LL", "OF", "ML") for m in range(4)]
    assert [k for k in need if not hits[k]] == []


@pytest.mark.parametrize("level", [1, 5, 22])
def test_zstandard_frames_with_checksums(level):
    c = zstandard.ZstdCompressor(level=level, write_checksum=True)
    for arr in CASES.values():
        data = arr.tobytes()
        assert zstd.decompress(c.compress(data)) == data


def test_frames_in_a_row_and_skippable_frames():
    a, b = CASES["text"].tobytes(), CASES["floats"].tobytes()
    c = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skip = (zstd.SKIPPABLE_MAGIC + 5).to_bytes(4, "little") + \
        (3).to_bytes(4, "little") + b"xyz"
    buf = c.compress(a) + skip + c.compress(b) + zstd.compress(a)
    assert zstd.decompress(buf) == a + b + a


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000])
def test_xxh64_is_xxhash(n):
    data = RNG.bytes(n)
    assert zstd.xxh64(data) == xxhash.xxh64_intdigest(data)


@pytest.mark.parametrize("source", ["tensorstore", "zstandard"])
def test_every_truncation_raises(source):
    data = CASES["text"].tobytes()[:6000] + CASES["floats"].tobytes()[:3000]
    frame = (tensorstore_frame(np.frombuffer(data, np.uint8), 3)
             if source == "tensorstore" else
             zstandard.ZstdCompressor(level=19).compress(data))
    assert zstd.decompress(frame) == data
    for cut in range(len(frame)):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut])


def test_corrupt_checksummed_frames_raise():
    data = CASES["text"].tobytes()[:3000]
    frame = zstandard.ZstdCompressor(level=3,
                                     write_checksum=True).compress(data)
    for i in range(len(frame)):
        bad = bytearray(frame)
        # The descriptor's bit 4 is unused (RFC 8878 ignores it); its bit
        # 3 is reserved and must be 0.
        bad[i] ^= 0x08 if i == 4 else 0x10
        with pytest.raises(ValueError):
            zstd.decompress(bytes(bad))


def test_dictionaries_and_garbage_raise():
    plain = zstd.compress(b"hi" * 50)      # single segment, 1-byte size
    frame = plain[:4] + bytes([plain[4] | 1, 5]) + plain[5:]   # dict id 5
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(frame)
    for junk in (b"", b"\x28\xb5\x2f", b"not a zstd frame", os.urandom(64)):
        with pytest.raises(ValueError):
            zstd.decompress(junk)


@pytest.mark.parametrize("name", ["random", "zeros", "over_128k", "empty"])
def test_port_frames_read_by_tensorstore_and_zstandard(name):
    arr = CASES.get(name, np.zeros(0, np.uint8))
    frame = zstd.compress(arr.tobytes())
    assert zstd.decompress(frame) == arr.tobytes()
    assert zstandard.ZstdDecompressor().decompress(frame) == arr.tobytes()
    if arr.size:
        t = ts.open({"driver": "zarr",
                     "kvstore": {"driver": "memory", "path": "a/"},
                     "metadata": {"compressor": {"id": "zstd", "level": 1},
                                  "shape": list(arr.shape),
                                  "chunks": list(arr.shape),
                                  "dtype": arr.dtype.str},
                     "create": True}).result()
        t.kvstore.write(b"0", frame).result()
        np.testing.assert_array_equal(t.read().result(), arr)
    if name == "zeros":
        assert block_kinds(frame) == [1]


def weight_matrix() -> np.ndarray:
    """The matrix of ``tests/data/zstd_weights_level1.zst``: uniform in
    +-1/16, as a layer's initial weights are."""
    return np.random.RandomState(0).uniform(-0.0625, 0.0625,
                                            (256, 100)).astype(np.float32)


def test_committed_weight_frame():
    path = os.path.join(os.path.dirname(__file__), "data",
                        "zstd_weights_level1.zst")
    with open(path, "rb") as f:
        frame = f.read()
    assert block_kinds(frame) == [2]
    assert zstd.decompress(frame) == weight_matrix().tobytes()
    assert zstd.decompress(tensorstore_frame(weight_matrix(), 1)) == \
        weight_matrix().tobytes()
