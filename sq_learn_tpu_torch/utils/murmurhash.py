"""MurmurHash3 x86_32 in numpy (the port's own copy of the hash
``sq_learn_tpu.native.murmurhash3_bulk`` computes in C++, and of the one
the reference vendors in ``utils/src/MurmurHash3.cpp``).

Tokens are hashed over their UTF-8 bytes. The rounds run over all tokens
at once: one vectorized pass per 4-byte block index, with the tokens
ordered by block count so that the tokens still in a round are a prefix.
"""

import numpy as np

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix(h):
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _mix_k(k):
    return _rotl(k * _C1, 15) * _C2


def _encode(tokens):
    out = []
    for t in tokens:
        if isinstance(t, str):
            out.append(t.encode("utf-8"))
        elif isinstance(t, (bytes, bytearray)):
            out.append(bytes(t))
        else:
            raise TypeError(
                f"tokens must be str or bytes, got {type(t).__name__}")
    return out


def murmurhash3_32(tokens, seed=0):
    """MurmurHash3 x86_32 of each str/bytes token; a uint32 array (view it
    as int32 for the signed hash)."""
    enc = _encode(tokens)
    n = len(enc)
    if n == 0:
        return np.zeros(0, np.uint32)
    lengths = np.fromiter(map(len, enc), np.int64, count=n)
    # four zero bytes past the end: tail reads never leave the buffer
    buf = np.frombuffer(b"".join(enc) + b"\0\0\0\0", np.uint8).astype(
        np.uint32)
    offsets = np.zeros(n, np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    nblocks = lengths // 4
    order = np.argsort(-nblocks, kind="stable")
    base = offsets[order]
    h = np.full(n, seed & 0xFFFFFFFF, np.uint32)
    neg = -nblocks[order]
    for j in range(int(nblocks.max())):
        live = int(np.searchsorted(neg, -j, side="left"))
        at = base[:live] + 4 * j
        k = (buf[at] | (buf[at + 1] << np.uint32(8))
             | (buf[at + 2] << np.uint32(16))
             | (buf[at + 3] << np.uint32(24)))
        hj = h[:live] ^ _mix_k(k)
        h[:live] = _rotl(hj, 13) * np.uint32(5) + np.uint32(0xE6546B64)
    h_tok = np.empty_like(h)
    h_tok[order] = h
    tail = lengths & 3
    at = offsets + 4 * nblocks
    k = np.zeros(n, np.uint32)
    for t in (2, 1, 0):
        k ^= np.where(tail > t, buf[at + t] << np.uint32(8 * t),
                      np.uint32(0)).astype(np.uint32)
    h_tok ^= _mix_k(k)
    h_tok ^= lengths.astype(np.uint32)
    return _fmix(h_tok)
