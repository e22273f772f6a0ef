"""zstd compression via a ctypes binding of the system libzstd.

Counterpart of ``backuwup_tpu/utils/zstd.py``, copied so that the port imports
nothing of the JAX package; what it writes is byte-identical.

The reference compresses every blob with zstd level 3 through the Rust
``zstd`` crate (``packfile/pack.rs:59-64``, ``packfile/mod.rs:31``).  This
binds the same C library directly; if libzstd is unavailable the caller can
fall back to zlib (``CompressionKind.ZLIB`` exists in the wire model for
exactly that).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_int]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def compress(data: bytes, level: int = 3) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd not available")
    data = bytes(data)
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(out, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise RuntimeError("ZSTD_compress failed")
    return out.raw[:n]


def decompress(data: bytes, max_size: int = 1 << 31) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd not available")
    data = bytes(data)
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size in (2**64 - 1, 2**64 - 2) or size > max_size:  # error/unknown
        raise ValueError("zstd frame has unknown or oversized content size")
    out = ctypes.create_string_buffer(max(1, size))
    n = lib.ZSTD_decompress(out, size, data, len(data))
    if lib.ZSTD_isError(n) or n != size:
        raise RuntimeError("ZSTD_decompress failed")
    return out.raw[:n]
