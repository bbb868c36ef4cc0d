"""The shard codec: CRC-32 and an LZ4 block codec with a byte-shuffle
filter (the port's copy of the pure-Python codec of
``sq_learn_tpu/native/__init__.py:567-860``).

Stores interchange between the two packages, so every payload here is
byte-identical to the JAX package's: the same greedy LZ4 matcher
(single-slot 2¹⁶ hash, insert at every scanned position, forward
extension only), the same filter header byte in front of each
:func:`compress_array` payload (0 plain LZ4, 1 byte-shuffled LZ4, 2
stored raw), and :func:`crc32` is ``zlib.crc32``, to which the JAX
package's native CRC is bit-identical. This is host code; nothing here
runs on the card. The matcher is pure Python (about 2 MB/s, and it holds
the GIL): a compressed store suits shards that are read far more often
than they are written.
"""

import zlib

import numpy as np

__all__ = [
    "byte_shuffle",
    "byte_unshuffle",
    "compress_array",
    "crc32",
    "decompress_array",
    "lz4_bound",
    "lz4_compress",
    "lz4_decompress",
]

_LZ_MFLIMIT = 12   # no match search this close to the end
_LZ_LASTLIT = 5    # the final 5 bytes stay literal
_LZ_HBITS = 16

#: in-band filter codes of :func:`compress_array` payloads (header byte 0)
_ENC_PLAIN, _ENC_SHUFFLE, _ENC_RAW = 0, 1, 2


def _as_u8(data):
    """A C-contiguous uint8 view or copy of a bytes-like or ndarray."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data)
        return buf.reshape(-1).view(np.uint8) if buf.size else \
            np.empty(0, np.uint8)
    return np.frombuffer(data, np.uint8)


def crc32(data, value=0):
    """CRC-32 of a contiguous buffer (an ndarray of any dtype, or a
    bytes-like object), continuing from ``value``; ``zlib.crc32``."""
    if isinstance(data, np.ndarray):
        data = _as_u8(data)
    return zlib.crc32(data, value) & 0xFFFFFFFF


def lz4_bound(n):
    """Worst-case compressed size for ``n`` input bytes."""
    n = int(n)
    return n + n // 255 + 16


def lz4_compress(data):
    """Compress a bytes-like or ndarray buffer into an LZ4 block
    (bytes)."""
    src = _as_u8(data).tobytes()
    n = len(src)
    out = bytearray()
    if n == 0:
        return bytes(out)
    table = [-1] * (1 << _LZ_HBITS)
    pos = anchor = 0
    limit = n - _LZ_MFLIMIT

    def emit(lit, mlen_m4, off):
        out.append((min(lit, 15) << 4) | (min(mlen_m4, 15) if off else 0))
        rem = lit - 15
        while rem >= 0:
            out.append(min(rem, 255))
            if rem < 255:
                break
            rem -= 255
        out.extend(src[anchor:anchor + lit])
        if off:
            out.append(off & 0xFF)
            out.append(off >> 8)
            rem = mlen_m4 - 15
            while rem >= 0:
                out.append(min(rem, 255))
                if rem < 255:
                    break
                rem -= 255

    while pos <= limit:
        seq = src[pos:pos + 4]
        h = ((int.from_bytes(seq, "little") * 2654435761)
             & 0xFFFFFFFF) >> (32 - _LZ_HBITS)
        cand = table[h]
        table[h] = pos
        if cand >= 0 and pos - cand <= 0xFFFF and src[cand:cand + 4] == seq:
            mlen = 4
            end = n - _LZ_LASTLIT
            while pos + mlen < end and src[pos + mlen] == src[cand + mlen]:
                mlen += 1
            emit(pos - anchor, mlen - 4, pos - cand)
            pos += mlen
            anchor = pos
        else:
            pos += 1
    emit(n - anchor, 0, 0)
    return bytes(out)


def lz4_decompress(data, raw_n):
    """Decompress an LZ4 block into a writable uint8 array of ``raw_n``
    bytes. Every read and write is bounds-checked: malformed input raises
    ``ValueError``, never overruns."""
    buf = _as_u8(data).tobytes()
    raw_n = int(raw_n)
    if raw_n == 0:
        if buf:
            raise ValueError("malformed LZ4 block: bytes after empty raw")
        return np.empty(0, np.uint8)
    n = len(buf)
    out = bytearray(raw_n)
    ip = op = 0
    while ip < n:
        token = buf[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise ValueError("truncated literal length")
                b = buf[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n or op + lit > raw_n:
            raise ValueError("literal overrun")
        out[op:op + lit] = buf[ip:ip + lit]
        ip += lit
        op += lit
        if ip >= n:
            break  # final literal-only sequence
        if ip + 2 > n:
            raise ValueError("truncated match offset")
        off = buf[ip] | (buf[ip + 1] << 8)
        ip += 2
        if off == 0 or off > op:
            raise ValueError("bad match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if ip >= n:
                    raise ValueError("truncated match length")
                b = buf[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        if op + mlen > raw_n:
            raise ValueError("match overrun")
        src_i = op - off
        for k in range(mlen):
            out[op + k] = out[src_i + k]
        op += mlen
    if op != raw_n:
        raise ValueError(f"decompressed {op} of {raw_n} bytes")
    return np.frombuffer(bytes(out), np.uint8).copy()


def byte_shuffle(arr):
    """Byte-plane transpose: elements of ``itemsize`` w become w
    contiguous byte planes (plane k holds byte k of every element), which
    groups the low-entropy bytes of float data into matchable runs."""
    flat = _as_u8(arr)
    w = arr.dtype.itemsize if isinstance(arr, np.ndarray) else 1
    if w == 1 or flat.size == 0:
        return flat.copy()
    return np.ascontiguousarray(flat.reshape(-1, w).T).reshape(-1)


def byte_unshuffle(flat, itemsize):
    """Inverse of :func:`byte_shuffle` (a contiguous uint8 array)."""
    flat = _as_u8(flat)
    w = int(itemsize)
    if w == 1 or flat.size == 0:
        return flat.copy()
    if flat.size % w:
        raise ValueError(f"{flat.size} bytes is not a multiple of "
                         f"itemsize {w}")
    return np.ascontiguousarray(flat.reshape(w, -1).T).reshape(-1)


def compress_array(arr):
    """Codec payload of one array: the filter header byte, then the
    smaller of the plain and the byte-shuffled LZ4 streams, or the raw
    bytes when neither is smaller than them."""
    a = np.ascontiguousarray(arr)
    raw = _as_u8(a)
    best, code = lz4_compress(raw), _ENC_PLAIN
    if a.dtype.itemsize > 1 and a.size:
        shuffled = lz4_compress(byte_shuffle(a))
        if len(shuffled) < len(best):
            best, code = shuffled, _ENC_SHUFFLE
    if len(best) >= raw.size:
        return bytes([_ENC_RAW]) + raw.tobytes()
    return bytes([code]) + best


def decompress_array(payload, dtype, shape):
    """Decode a :func:`compress_array` payload back to the exact array.
    Malformed payloads, a decoded size that disagrees with
    ``dtype``/``shape`` included, raise ``ValueError``."""
    dtype = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    raw_n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    buf = _as_u8(payload)
    if buf.size == 0:
        raise ValueError("empty codec payload")
    code, body = int(buf[0]), buf[1:]
    if code == _ENC_RAW:
        if body.size != raw_n:
            raise ValueError(
                f"raw payload is {body.size} bytes, expected {raw_n}")
        flat = body.copy()
    elif code == _ENC_PLAIN:
        flat = lz4_decompress(body, raw_n)
    elif code == _ENC_SHUFFLE:
        flat = byte_unshuffle(lz4_decompress(body, raw_n), dtype.itemsize)
    else:
        raise ValueError(f"unknown codec filter byte {code}")
    return flat.view(dtype).reshape(shape)
