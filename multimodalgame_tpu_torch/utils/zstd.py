"""Zstandard frames (RFC 8878) in pure Python, for Orbax checkpoints.

Every layer of an Orbax checkpoint directory is compressed with zstd:
tensorstore's OCDBT manifest and B-tree nodes (``utils/ocdbt.py``) and the
zarr chunks of each array (``utils/orbax.py``). This is the port's own
codec, for machines without ``zstandard``, ``numcodecs`` or
``tensorstore``.

:func:`decompress` reads everything RFC 8878 defines but dictionaries:

* frames: the header's window descriptor, single-segment flag and frame
  content size (checked against the output), dictionary id 0 only, the
  XXH64 content checksum when its flag is set, any number of frames in
  one buffer, and skippable frames (skipped);
* raw, RLE and compressed blocks;
* literals: raw, RLE, Huffman-coded with direct or FSE-compressed weights
  in 1 or 4 streams, and treeless (the frame's previous Huffman table);
* sequences: predefined, RLE, FSE-compressed and repeat table modes, the
  three repeat offsets and overlapping matches.

Decoding runs through tables, never through one big integer: a Huffman
table of ``2**max_bits`` entries, FSE state tables, and a backward bit
reader that refills 32 bits at a time. Bytes that are not a zstd frame,
a truncated frame, a bitstream not consumed exactly, or a checksum that
does not match raise :class:`ZstdError`, a ``ValueError``.

:func:`compress` writes a valid frame of raw blocks, and of RLE blocks
where a block is one byte repeated: tensorstore reads it as it reads its
own frames. It does not search for matches, so it does not shrink
weights (float32 weights hardly compress anyway).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 * 1024
_MASKS = [(1 << n) - 1 for n in range(65)]


class ZstdError(ValueError):
    """Bytes that are not a valid zstd frame."""


# ------------------------------------------------------------- XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (((acc << 31) | (acc >> 33)) & _M64) * _P1 & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0 (the hash zstd's content checksum
    truncates)."""
    n, p = len(data), 0
    if n >= 32:
        v1, v2, v3, v4 = (_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64
        stop = n - n % 32
        for a, b, c, d in struct.iter_unpack("<4Q", data[:stop]):
            v1, v2 = _round(v1, a), _round(v2, b)
            v3, v4 = _round(v3, c), _round(v4, d)
        p = stop
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (k * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = _rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------- bit readers

class _BackBits:
    """The backward bitstream of RFC 8878 §4.1: ``buf[start:end]`` read
    from its last byte down, after the highest set bit of that byte.
    ``acc`` holds the ``nacc`` next bits in its low end, refilled 32
    bits at a time; ``left`` counts the bits not yet read (negative once
    a read ran past the start, which is an overflow)."""

    __slots__ = ("buf", "start", "ptr", "acc", "nacc", "left")

    def __init__(self, buf: bytes, start: int, end: int):
        if end <= start or buf[end - 1] == 0:
            raise ZstdError("a bitstream lacks its end marker")
        last = buf[end - 1]
        hb = last.bit_length() - 1
        self.buf, self.start, self.ptr = buf, start, end - 1
        self.acc, self.nacc = last & _MASKS[hb], hb
        self.left = hb + 8 * (end - 1 - start)

    def _refill(self) -> None:
        ptr, start = self.ptr, self.start
        if ptr - start >= 4:
            self.acc = ((self.acc & _MASKS[self.nacc]) << 32) | \
                int.from_bytes(self.buf[ptr - 4:ptr], "little")
            self.ptr = ptr - 4
            self.nacc += 32
        else:
            acc = self.acc & _MASKS[self.nacc]
            while ptr > start:
                ptr -= 1
                acc = (acc << 8) | self.buf[ptr]
                self.nacc += 8
            self.acc, self.ptr = acc, ptr

    def read(self, n: int) -> int:
        """The next ``n`` bits (zeros past the start of the stream)."""
        if n == 0:
            return 0
        if self.nacc < n:
            self._refill()
            if self.nacc < n:      # past the start: pad with zeros
                v = (self.acc << (n - self.nacc)) & _MASKS[n]
                self.left -= n
                self.nacc = 0
                self.acc = 0
                return v
        self.nacc -= n
        self.left -= n
        return (self.acc >> self.nacc) & _MASKS[n]


def _fwd_bits(buf: bytes, bitpos: int, n: int) -> int:
    """``n`` (<= 25) bits at ``bitpos`` of a forward (little-endian)
    bitstream."""
    byte = bitpos >> 3
    return (int.from_bytes(buf[byte:byte + 4], "little")
            >> (bitpos & 7)) & _MASKS[n]


# ---------------------------------------------------------------- FSE

class _FseTable:
    """An FSE decoding table: per state its symbol, the number of bits
    to read and the baseline the next state adds them to."""

    __slots__ = ("log", "sym", "nb", "base")

    def __init__(self, log: int, sym, nb, base):
        self.log, self.sym, self.nb, self.base = log, sym, nb, base

    @classmethod
    def from_counts(cls, counts: List[int], log: int) -> "_FseTable":
        size = 1 << log
        sym = [0] * size
        high = size - 1
        for s, c in enumerate(counts):
            if c == -1:
                sym[high] = s
                high -= 1
        step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
        for s, c in enumerate(counts):
            for _ in range(c if c > 0 else 0):
                sym[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdError("an FSE distribution does not fill its table")
        nxt = [1 if c == -1 else max(c, 0) for c in counts]
        nb, base = [0] * size, [0] * size
        for u in range(size):
            s = sym[u]
            x = nxt[s]
            nxt[s] = x + 1
            b = log - (x.bit_length() - 1)
            nb[u] = b
            base[u] = (x << b) - size
        return cls(log, sym, nb, base)

    @classmethod
    def rle(cls, symbol: int) -> "_FseTable":
        return cls(0, [symbol], [0], [0])


def _read_fse_counts(buf: bytes, pos: int, end: int, max_log: int,
                     max_sym: int) -> Tuple[List[int], int, int]:
    """An FSE table description (RFC 8878 §4.1.1) at ``buf[pos:]``;
    returns ``(counts, accuracy log, position after it)``."""
    if pos >= end:
        raise ZstdError("an FSE table description is truncated")
    limit = 8 * end
    bit = 8 * pos
    log = _fwd_bits(buf, bit, 4) + 5
    bit += 4
    if log > max_log:
        raise ZstdError(f"an FSE accuracy log {log} exceeds {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1 and len(counts) <= max_sym:
        v = _fwd_bits(buf, bit, nbits)
        top = 2 * threshold - 1 - remaining
        if (v & (threshold - 1)) < top:
            c = v & (threshold - 1)
            bit += nbits - 1
        else:
            c = v & (2 * threshold - 1)
            if c >= threshold:
                c -= top
            bit += nbits
        c -= 1
        remaining -= -c if c < 0 else c
        counts.append(c)
        if c == 0:
            while True:
                rep = _fwd_bits(buf, bit, 2)
                bit += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if bit > limit:
            raise ZstdError("an FSE table description is truncated")
    if remaining != 1 or len(counts) > max_sym + 1 or bit > limit:
        raise ZstdError("an FSE table description is malformed")
    return counts, log, (bit + 7) >> 3


# ------------------------------------------------ predefined sequences

_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
               2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, -1, -1, -1, -1, -1]
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                 99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]
# (max symbol, max accuracy log, predefined counts, predefined log)
_SEQ_KINDS = ((35, 9, _LL_DEFAULT, 6), (31, 8, _OF_DEFAULT, 5),
              (52, 9, _ML_DEFAULT, 6))


# ------------------------------------------------------------ Huffman

class _Huffman:
    """A Huffman decoding table: the symbol and code length of every
    ``max_bits``-bit prefix."""

    __slots__ = ("bits", "sym", "nb")

    def __init__(self, weights: List[int]):
        total = sum((1 << w) >> 1 for w in weights)
        if total == 0:
            raise ZstdError("Huffman weights are all zero")
        bits = total.bit_length()
        rest = (1 << bits) - total
        if bits > 11 or rest & (rest - 1):
            raise ZstdError("Huffman weights do not complete a code")
        weights = weights + [rest.bit_length()]
        sym, nb = [], []
        for w in range(1, bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    sym.extend([s] * (1 << (w - 1)))
                    nb.extend([bits + 1 - w] * (1 << (w - 1)))
        self.bits, self.sym, self.nb = bits, sym, nb


def _huffman_weights(buf: bytes, pos: int, end: int) -> Tuple[List[int], int]:
    """The Huffman tree description at ``buf[pos:]`` (RFC 8878
    §4.2.1); returns ``(weights of all symbols but the last, position
    after it)``."""
    if pos >= end:
        raise ZstdError("a Huffman tree description is truncated")
    head = buf[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        stop = pos + (n + 1) // 2
        if stop > end:
            raise ZstdError("a Huffman tree description is truncated")
        weights = []
        for b in buf[pos:stop]:
            weights += [b >> 4, b & 15]
        return weights[:n], stop
    stop = pos + head
    if head == 0 or stop > end:
        raise ZstdError("a Huffman tree description is truncated")
    counts, log, p = _read_fse_counts(buf, pos, stop, 6, 255)
    t = _FseTable.from_counts(counts, log)
    bits = _BackBits(buf, p, stop)
    s1, s2 = bits.read(log), bits.read(log)
    weights: List[int] = []
    while True:
        weights.append(t.sym[s1])
        s1 = t.base[s1] + bits.read(t.nb[s1])
        if bits.left < 0:
            weights.append(t.sym[s2])
            break
        weights.append(t.sym[s2])
        s2 = t.base[s2] + bits.read(t.nb[s2])
        if bits.left < 0:
            weights.append(t.sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    if any(w > 11 for w in weights):
        raise ZstdError("a Huffman weight exceeds 11")
    return weights, stop


def _huffman_stream(buf: bytes, start: int, end: int, huf: _Huffman,
                    n: int, out: bytearray) -> None:
    """Decode ``n`` literals of one Huffman stream ``buf[start:end]``
    into ``out``; the stream must end exactly. The loop is most of a
    read's time, so it keeps :class:`_BackBits`'s state in locals."""
    r = _BackBits(buf, start, end)
    bits, sym, nb, mask = huf.bits, huf.sym, huf.nb, _MASKS[huf.bits]
    acc, nacc = r.acc, r.nacc
    ptr, refill_stop = r.ptr, start + 4
    append = out.append
    for _ in range(n):
        if nacc < bits:
            if ptr >= refill_stop:
                acc = ((acc & _MASKS[nacc]) << 32) | \
                    int.from_bytes(buf[ptr - 4:ptr], "little")
                ptr -= 4
                nacc += 32
            else:
                acc &= _MASKS[nacc]
                while ptr > start:
                    ptr -= 1
                    acc = (acc << 8) | buf[ptr]
                    nacc += 8
        if nacc >= bits:
            i = (acc >> (nacc - bits)) & mask
        else:
            i = (acc << (bits - nacc)) & mask
        nacc -= nb[i]
        if nacc < 0:
            raise ZstdError("a Huffman stream ends early")
        append(sym[i])
    if nacc or ptr > start:
        raise ZstdError("a Huffman stream has bits left over")


# ------------------------------------------------------------- frames

class _FrameState:
    """What a frame's blocks hand to the next: the Huffman table, the
    three sequence tables and the repeat offsets."""

    __slots__ = ("huffman", "tables", "reps")

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables: List[Optional[_FseTable]] = [None, None, None]
        self.reps = [1, 4, 8]


def _literals(buf: bytes, pos: int, end: int,
              st: _FrameState) -> Tuple[bytes, int]:
    """The literals section of a compressed block at ``buf[pos:end]``;
    returns ``(literals, position after the section)``."""
    b0 = buf[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:                                   # raw or RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) | (buf[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) | (buf[pos + 1] << 4) | (buf[pos + 2] << 12)
            pos += 3
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals run past their block")
            return bytes(buf[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("RLE literals run past their block")
        return bytes([buf[pos]]) * size, pos + 1
    head = 3 + max(fmt - 1, 0)
    if pos + head > end:
        raise ZstdError("a literals header runs past its block")
    v = int.from_bytes(buf[pos:pos + head], "little")
    width = (10, 10, 14, 18)[fmt]
    size = (v >> 4) & _MASKS[width]
    csize = (v >> (4 + width)) & _MASKS[width]
    streams = 1 if fmt == 0 else 4
    pos += head
    stop = pos + csize
    if stop > end:
        raise ZstdError("compressed literals run past their block")
    if kind == 2:
        weights, pos = _huffman_weights(buf, pos, stop)
        st.huffman = _Huffman(weights)
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier table")
    out = bytearray()
    if streams == 1:
        _huffman_stream(buf, pos, stop, st.huffman, size, out)
    else:
        if pos + 6 > stop:
            raise ZstdError("a literals jump table is truncated")
        s1, s2, s3 = struct.unpack_from("<3H", buf, pos)
        pos += 6
        each = (size + 3) // 4
        bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop]
        if bounds[3] > stop or size < 3 * each:
            raise ZstdError("a literals jump table is malformed")
        for i in range(4):
            _huffman_stream(buf, bounds[i], bounds[i + 1], st.huffman,
                            each if i < 3 else size - 3 * each, out)
    return bytes(out), stop


def _sequences(buf: bytes, pos: int, end: int, st: _FrameState,
               lits: bytes, out: bytearray) -> None:
    """Decode the sequences section ``buf[pos:end]`` and execute it on
    ``lits`` into ``out`` (the frame's output so far)."""
    if pos >= end:
        raise ZstdError("a block lacks its sequences section")
    b0 = buf[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ZstdError("a block has bytes after zero sequences")
        out += lits
        return
    if b0 < 128:
        count, pos = b0, pos + 1
    elif b0 < 255:
        count, pos = ((b0 - 128) << 8) + buf[pos + 1], pos + 2
    else:
        count, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= end:
        raise ZstdError("a sequences header is truncated")
    modes = buf[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits are set in the sequence modes")
    for i, (max_sym, max_log, default, dlog) in enumerate(_SEQ_KINDS):
        mode = (modes >> (6 - 2 * i)) & 3
        if mode == 0:
            st.tables[i] = _FseTable.from_counts(default, dlog)
        elif mode == 1:
            if pos >= end or buf[pos] > max_sym:
                raise ZstdError("an RLE sequence symbol is invalid")
            st.tables[i] = _FseTable.rle(buf[pos])
            pos += 1
        elif mode == 2:
            counts, log, pos = _read_fse_counts(buf, pos, end, max_log,
                                                max_sym)
            st.tables[i] = _FseTable.from_counts(counts, log)
        elif st.tables[i] is None:
            raise ZstdError("a repeated sequence table without an earlier "
                            "one")
    ll_t, of_t, ml_t = st.tables
    r = _BackBits(buf, pos, end)
    read = r.read
    ll_s, of_s, ml_s = read(ll_t.log), read(of_t.log), read(ml_t.log)
    ll_sym, ll_nb, ll_base = ll_t.sym, ll_t.nb, ll_t.base
    of_sym, of_nb, of_base = of_t.sym, of_t.nb, of_t.base
    ml_sym, ml_nb, ml_base = ml_t.sym, ml_t.nb, ml_t.base
    r1, r2, r3 = st.reps
    lp = 0
    for k in range(count):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31:
            raise ZstdError("an offset code exceeds 31")
        ofv = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if ofv > 3:
            r1, r2, r3 = ofv - 3, r1, r2
        else:
            idx = ofv if ll else ofv + 1
            if idx == 2:
                r1, r2 = r2, r1
            elif idx == 3:
                r1, r2, r3 = r3, r1, r2
            elif idx == 4:
                r1, r2, r3 = r1 - 1, r1, r2
        if k + 1 < count:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > len(lits):
            raise ZstdError("a sequence reads past its literals")
        out += lits[lp:lp + ll]
        lp += ll
        off = r1
        n = len(out)
        if off == 0 or off > n:
            raise ZstdError(f"a match offset {off} reaches before the "
                            "frame")
        if off >= ml:
            out += out[n - off:n - off + ml]
        else:
            piece = out[n - off:]
            out += (piece * (ml // off + 1))[:ml]
    if r.left != 0:
        raise ZstdError("a sequences bitstream has bits left over"
                        if r.left > 0 else "a sequences bitstream ends "
                        "early")
    st.reps = [r1, r2, r3]
    out += lits[lp:]


def _frame(buf: bytes, pos: int) -> Tuple[bytes, int]:
    """The frame at ``buf[pos:]`` (after its magic number); returns
    ``(content, position after the frame)``."""
    n = len(buf)
    if pos >= n:
        raise ZstdError("a frame header is truncated")
    fhd = buf[pos]
    pos += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("the frame header's reserved bit is set")
    if not single:
        pos += 1                                   # window descriptor
    dict_size = (0, 1, 2, 4)[dict_flag]
    if dict_size:
        if int.from_bytes(buf[pos:pos + dict_size], "little"):
            raise ZstdError("the frame needs a dictionary")
        pos += dict_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > n:
        raise ZstdError("a frame header is truncated")
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(buf[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
        pos += fcs_size
    out = bytearray()
    st = _FrameState()
    while True:
        if pos + 3 > n:
            raise ZstdError("a block header is truncated")
        head = int.from_bytes(buf[pos:pos + 3], "little")
        pos += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if kind == 1:
            if pos + 1 > n:
                raise ZstdError("an RLE block is truncated")
            out += bytes([buf[pos]]) * size
            pos += 1
        else:
            stop = pos + size
            if stop > n:
                raise ZstdError("a block is truncated")
            if kind == 0:
                out += buf[pos:stop]
            elif kind == 2:
                if size == 0:
                    raise ZstdError("an empty compressed block")
                lits, p = _literals(buf, pos, stop, st)
                _sequences(buf, p, stop, st, lits, out)
            else:
                raise ZstdError("a block of the reserved type")
            pos = stop
        if last:
            break
    if fcs is not None and fcs != len(out):
        raise ZstdError(f"a frame decodes to {len(out)} bytes, its header "
                        f"says {fcs}")
    if checksum:
        if pos + 4 > n:
            raise ZstdError("a frame's checksum is truncated")
        want = int.from_bytes(buf[pos:pos + 4], "little")
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("a frame's content checksum does not match")
        pos += 4
    return bytes(out), pos


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data``, joined."""
    buf = bytes(data)
    pos, parts = 0, []
    if not buf:
        raise ZstdError("no zstd frame in an empty buffer")
    while pos < len(buf):
        if pos + 4 > len(buf):
            raise ZstdError("a frame's magic number is truncated")
        (magic,) = struct.unpack_from("<I", buf, pos)
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            if pos + 8 > len(buf):
                raise ZstdError("a skippable frame is truncated")
            (size,) = struct.unpack_from("<I", buf, pos + 4)
            pos += 8 + size
            if pos > len(buf):
                raise ZstdError("a skippable frame is truncated")
            continue
        if magic != MAGIC:
            raise ZstdError(f"bad zstd magic number 0x{magic:08x}")
        try:
            content, pos = _frame(buf, pos + 4)
        except (IndexError, struct.error):
            raise ZstdError("a zstd frame is truncated") from None
        parts.append(content)
    return b"".join(parts)


def compress(data: bytes) -> bytes:
    """One zstd frame of ``data`` in raw blocks, and RLE blocks where a
    block is one byte repeated; single-segment, with the content size."""
    data = bytes(data)
    n = len(data)
    if n < 256:
        fcs_flag, fcs = 0, struct.pack("<B", n)
    elif n < 65536 + 256:
        fcs_flag, fcs = 1, struct.pack("<H", n - 256)
    elif n < 1 << 32:
        fcs_flag, fcs = 2, struct.pack("<I", n)
    else:
        fcs_flag, fcs = 3, struct.pack("<Q", n)
    out = [struct.pack("<IB", MAGIC, (fcs_flag << 6) | 0x20), fcs]
    starts = range(0, n, BLOCK_MAX) if n else [0]
    for s in starts:
        block = data[s:s + BLOCK_MAX]
        last = int(s + BLOCK_MAX >= n)
        if len(block) > 1 and block.count(block[:1]) == len(block):
            out += [(last | 2 | len(block) << 3).to_bytes(3, "little"),
                    block[:1]]
        else:
            out += [(last | len(block) << 3).to_bytes(3, "little"), block]
    return b"".join(out)
