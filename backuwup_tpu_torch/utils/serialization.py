"""Deterministic little-endian binary codec for data-plane structures.

Counterpart of ``backuwup_tpu/utils/serialization.py``, copied so that the port imports
nothing of the JAX package; what it writes is byte-identical.

The reference serializes blobs/trees/p2p bodies with bincode
(``dir_packer.rs:321``, ``transport.rs:111-132``).  This is our equivalent:
fixed-width little-endian integers, ``u64``-length-prefixed byte strings,
no implicit padding — byte-for-byte deterministic so that tree blobs hash
reproducibly and signatures verify across hosts.
"""

from __future__ import annotations

import struct
from typing import Optional


class Writer:
    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def u8(self, v: int) -> None:
        self._parts.append(struct.pack("<B", v))

    def u32(self, v: int) -> None:
        self._parts.append(struct.pack("<I", v))

    def u64(self, v: int) -> None:
        self._parts.append(struct.pack("<Q", v))

    def fixed(self, b: bytes) -> None:
        self._parts.append(bytes(b))

    def blob(self, b: bytes) -> None:
        self.u64(len(b))
        self._parts.append(bytes(b))

    def str(self, s: str) -> None:
        self.blob(s.encode("utf-8"))

    def opt_fixed(self, b: Optional[bytes], length: int) -> None:
        if b is None:
            self.u8(0)
        else:
            if len(b) != length:
                raise ValueError(f"opt_fixed expects {length} bytes")
            self.u8(1)
            self.fixed(b)

    def take(self) -> bytes:
        return b"".join(self._parts)


class CodecError(ValueError):
    pass


class Reader:
    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes) -> None:
        self._buf = memoryview(buf)
        self._pos = 0

    def _read(self, n: int) -> memoryview:
        if self._pos + n > len(self._buf):
            raise CodecError("unexpected end of buffer")
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return self._read(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._read(8))[0]

    def fixed(self, n: int) -> bytes:
        return bytes(self._read(n))

    def blob(self, max_len: int = 1 << 34) -> bytes:
        n = self.u64()
        if n > max_len:
            raise CodecError(f"blob length {n} exceeds cap {max_len}")
        return bytes(self._read(n))

    def str(self) -> str:
        return self.blob(1 << 20).decode("utf-8")

    def opt_fixed(self, length: int) -> Optional[bytes]:
        flag = self.u8()
        if flag == 0:
            return None
        if flag != 1:
            raise CodecError(f"bad option tag {flag}")
        return self.fixed(length)

    def remaining(self) -> int:
        return len(self._buf) - self._pos

    def expect_end(self) -> None:
        if self._pos != len(self._buf):
            raise CodecError(f"{len(self._buf) - self._pos} trailing bytes")
