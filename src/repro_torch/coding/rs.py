"""Reed-Solomon erasure coding over GF(256), pure Python.

The physical substrate of the payload-striping subsystem (Crossword,
PAPERS.md): a value's byte serialization is split into ``k`` data shards
and extended with ``m`` parity shards such that ANY ``k`` of the
``k + m`` shards reconstruct the original bytes exactly. Shards are
systematic (the first ``k`` are the data itself) and built by Lagrange
interpolation: shard ``i`` is the evaluation at field point ``i`` of the
unique degree-``< k`` polynomial through the data shards, one polynomial
per byte column.

Sizing note: the simulator models payload *bytes on the wire* through
``Msg.size_bytes`` (values can be megabytes of simulated traffic), but
the bytes actually pushed through this codec are the value's compact
serialization — real coding, verified shard-by-shard by the property
tests, without burning wall-clock on megabytes of GF arithmetic per op.

No dependencies beyond the standard library; everything is table-driven
(the classic 0x11d primitive polynomial) and sized for the small shard
counts a consensus group needs (k + m <= 255).
"""

from __future__ import annotations

from typing import Dict, List

_PRIM = 0x11D
_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]
del _x, _i


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(256) division by zero")
    if a == 0:
        return 0
    return _EXP[(_LOG[a] - _LOG[b]) % 255]


def _lagrange_row(xs: List[int], target: int) -> List[int]:
    """Coefficients c_i with value(target) = XOR_i gf_mul(c_i, value(xs[i]))
    for the unique degree-<len(xs) polynomial through the points ``xs``.
    (GF(2^8) addition is XOR, so subtraction is too.)"""
    row = []
    for i, xi in enumerate(xs):
        num = den = 1
        for j, xj in enumerate(xs):
            if j == i:
                continue
            num = gf_mul(num, target ^ xj)
            den = gf_mul(den, xi ^ xj)
        row.append(gf_div(num, den))
    return row


def shard_len(size: int, k: int) -> int:
    """Bytes per shard for a ``size``-byte payload split ``k`` ways."""
    return (size + k - 1) // k if size > 0 else 1


def encode(data: bytes, k: int, m: int) -> List[bytes]:
    """Split ``data`` into ``k`` data shards + ``m`` parity shards.

    Systematic: shards ``0..k-1`` are the (zero-padded) data itself;
    shards ``k..k+m-1`` are parity. Any ``k`` shards reconstruct."""
    if k < 1 or m < 0 or k + m > 255:
        raise ValueError(f"invalid shape k={k} m={m} (need 1<=k, 0<=m, "
                         f"k+m<=255)")
    sl = shard_len(len(data), k)
    padded = data.ljust(k * sl, b"\0")
    shards = [padded[i * sl:(i + 1) * sl] for i in range(k)]
    for t in range(k, k + m):
        row = _lagrange_row(list(range(k)), t)
        parity = bytearray(sl)
        for b in range(sl):
            acc = 0
            for i in range(k):
                acc ^= gf_mul(row[i], shards[i][b])
            parity[b] = acc
        shards.append(bytes(parity))
    return shards


def reconstruct(shards: Dict[int, bytes], k: int, m: int) -> List[bytes]:
    """Rebuild ALL ``k + m`` shards from any >= ``k`` present ones.

    ``shards`` maps shard index -> shard bytes. Raises ``ValueError``
    when fewer than ``k`` distinct shards are present (the erasure is
    unrecoverable — exactly the condition the weighted reconstructable
    commit gate exists to prevent)."""
    present = sorted(shards)
    if len(present) < k:
        raise ValueError(f"unrecoverable erasure: {len(present)} < k={k} "
                         f"shards present")
    if any(i < 0 or i >= k + m for i in present):
        raise ValueError(f"shard index out of range for k={k} m={m}: "
                         f"{present}")
    xs = present[:k]
    sl = len(shards[xs[0]])
    if any(len(shards[i]) != sl for i in xs):
        raise ValueError("ragged shards")
    cols = [shards[i] for i in xs]
    out: List[bytes] = []
    for t in range(k + m):
        if t in shards:
            out.append(shards[t])
            continue
        row = _lagrange_row(xs, t)
        rebuilt = bytearray(sl)
        for b in range(sl):
            acc = 0
            for i in range(k):
                acc ^= gf_mul(row[i], cols[i][b])
            rebuilt[b] = acc
        out.append(bytes(rebuilt))
    return out


def decode(shards: Dict[int, bytes], k: int, m: int, size: int) -> bytes:
    """Recover the original ``size``-byte payload from any >= ``k``
    shards (inverse of :func:`encode`)."""
    full = reconstruct(shards, k, m)
    return b"".join(full[:k])[:size]
