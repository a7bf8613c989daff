"""Wire codec for the asyncio transport: length-prefixed tagged frames.

A frame is a 4-byte big-endian length followed by one encoded message.
The body is msgpack when the interpreter has it, else compact JSON —
both carry the same *tagged tree*: protocol payloads are plain dicts and
lists of primitives except for a handful of Python shapes the simulator
passes by reference (``Op`` records, sets, tuples, int-keyed dicts),
which are wrapped in single-key tag objects so the decode side restores
the exact in-memory shape the protocol handlers expect:

  ``{"__op__": [...]}``   an :class:`repro_torch.core.simulator.Op`
  ``{"__set__": [...]}``  a set (``applied_ops`` in snapshots)
  ``{"__tup__": [...]}``  a tuple (``_obj_buffer`` entries)
  ``{"__map__": [[k, v], ...]}``  a dict with non-string keys
                          (stores, dep maps — JSON keys must be strings)

String-keyed payload dicts pass through untagged; the protocol never
uses keys that collide with the tag space (asserted on encode). numpy
scalars are converted to native ints/floats on the way out so the codec
stays dependency-free on the receive side.

The framing and the codec are deliberately independent of asyncio: the
unit tests round-trip encoded messages without opening a socket.
"""

from __future__ import annotations

import json
import struct
from typing import Tuple

import numpy as np

from repro_torch.core.simulator import Msg, Op

try:                              # optional fast path; the container image
    import msgpack                # may not ship it — JSON is the fallback
except ImportError:               # pragma: no cover - environment dependent
    msgpack = None

HEADER = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024      # sanity bound: a snapshot of a long soak
                                  # fits; a corrupt length prefix does not

_TAGS = ("__op__", "__set__", "__tup__", "__map__")


def _enc(x):
    t = type(x)
    if t is dict:
        if all(type(k) is str for k in x):
            assert not any(k in _TAGS for k in x), f"payload key collides " \
                f"with codec tag space: {sorted(x)}"
            return {k: _enc(v) for k, v in x.items()}
        return {"__map__": [[_enc(k), _enc(v)] for k, v in x.items()]}
    if t is list:
        return [_enc(v) for v in x]
    if t is Op:
        return {"__op__": [x.op_id, x.client, x.obj, x.kind, x.value,
                           x.submit_time, x.commit_time, x.path,
                           _enc(x.read_result), x.size]}
    if t is tuple:
        return {"__tup__": [_enc(v) for v in x]}
    if t is set or t is frozenset:
        return {"__set__": [_enc(v) for v in x]}
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x                      # str / int / float / bool / None


def _dec(x):
    if type(x) is dict:
        if len(x) == 1:
            if "__op__" in x:
                f = x["__op__"]
                # 9-field frames predate the payload-size axis: peers on
                # the old format decode as sizeless ops (size=0)
                return Op(f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                          _dec(f[8]), f[9] if len(f) > 9 else 0)
            if "__set__" in x:
                return {_dec(v) for v in x["__set__"]}
            if "__tup__" in x:
                return tuple(_dec(v) for v in x["__tup__"])
            if "__map__" in x:
                return {_dec(k): _dec(v) for k, v in x["__map__"]}
        return {k: _dec(v) for k, v in x.items()}
    if type(x) is list:
        return [_dec(v) for v in x]
    return x


def encode_msg(msg: Msg) -> bytes:
    """One framed message: header + tagged body. Raises ``ValueError``
    if the encoded body exceeds ``MAX_FRAME`` — the sender must refuse
    to emit a frame every receiver would reject as corrupt (data-heavy
    payloads above the bound belong in stripes, not one frame)."""
    tree = {"k": msg.kind, "s": msg.src, "d": msg.dst, "z": msg.size_ops,
            "p": _enc(msg.payload)}
    if msg.size_bytes:
        tree["b"] = msg.size_bytes    # absent = 0: old-format frames and
                                      # metadata-only messages stay byte-
                                      # identical on the wire
    if msgpack is not None:
        body = msgpack.packb(tree, use_bin_type=True)
    else:
        body = json.dumps(tree, separators=(",", ":")).encode()
    if len(body) > MAX_FRAME:
        raise ValueError(
            f"encoded frame body is {len(body)} bytes, exceeds MAX_FRAME "
            f"({MAX_FRAME}): refusing to emit an undecodable frame "
            f"(kind={msg.kind!r}, size_ops={msg.size_ops})")
    return HEADER.pack(len(body)) + body


def decode_body(body: bytes) -> Msg:
    if msgpack is not None:
        tree = msgpack.unpackb(body, raw=False, strict_map_key=False)
    else:
        tree = json.loads(body)
    return Msg(tree["k"], tree["s"], tree["d"], _dec(tree["p"]), tree["z"],
               tree.get("b", 0))


def encode_hello(node_id: int) -> bytes:
    """Connection preamble: the dialing side identifies itself so the
    server can route replies back over the same socket (clients) or
    account the peer (replicas)."""
    body = json.dumps({"hello": node_id}).encode()
    return HEADER.pack(len(body)) + body


def decode_hello(body: bytes) -> int:
    return json.loads(body)["hello"]


async def read_frame(reader) -> bytes:
    """Read one frame body from an asyncio StreamReader (raises
    ``asyncio.IncompleteReadError`` on EOF, ``ValueError`` on a corrupt
    length prefix)."""
    head = await reader.readexactly(HEADER.size)
    (length,) = HEADER.unpack(head)
    if length > MAX_FRAME:
        raise ValueError(f"frame length {length} exceeds MAX_FRAME")
    return await reader.readexactly(length)


def split_frames(buf: bytes) -> Tuple[list, bytes]:
    """Codec-level helper for non-asyncio consumers/tests: split a byte
    buffer into complete frame bodies + the unconsumed tail."""
    out = []
    off = 0
    while len(buf) - off >= HEADER.size:
        (length,) = HEADER.unpack_from(buf, off)
        if length > MAX_FRAME:
            raise ValueError(f"frame length {length} exceeds MAX_FRAME")
        if len(buf) - off - HEADER.size < length:
            break
        out.append(buf[off + HEADER.size: off + HEADER.size + length])
        off += HEADER.size + length
    return out, buf[off:]
