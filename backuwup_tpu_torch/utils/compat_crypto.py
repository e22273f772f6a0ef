"""libcrypto fallbacks for the ``cryptography`` package, via ctypes.

Counterpart of ``backuwup_tpu/utils/compat_crypto.py``, copied so that the port imports
nothing of the JAX package; what it writes is byte-identical.

Some deployment containers ship Python without the ``cryptography`` wheel
but always have OpenSSL's ``libcrypto`` on disk (hashlib/ssl link it).
This module exposes the exact primitive surface the codebase uses —
AES-256-GCM, ChaCha20 keystream, Ed25519 sign/verify, HKDF-SHA256 — with
call signatures mirroring ``cryptography``'s, so the import sites can gate:

    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ModuleNotFoundError:
        from ..utils.compat_crypto import AESGCM

All cipher work happens inside OpenSSL (EVP); nothing here rolls its own
crypto except the ~10-line RFC 5869 HKDF over :mod:`hmac`.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import hmac
import os

_EVP_CTRL_GCM_SET_IVLEN = 0x9
_EVP_CTRL_GCM_GET_TAG = 0x10
_EVP_CTRL_GCM_SET_TAG = 0x11
_EVP_PKEY_ED25519 = 1087  # NID_ED25519
_TAG_LEN = 16

_lib = None


def _libcrypto():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("crypto")
        candidates = [name] if name else []
        candidates += ["libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"]
        last = None
        for cand in candidates:
            if not cand:
                continue
            try:
                lib = ctypes.CDLL(cand)
                break
            except OSError as e:
                last = e
        else:
            raise ModuleNotFoundError(
                "neither the `cryptography` package nor libcrypto is "
                f"available: {last}")
        for fn in ("EVP_CIPHER_CTX_new", "EVP_aes_128_gcm", "EVP_aes_192_gcm",
                   "EVP_aes_256_gcm", "EVP_chacha20", "EVP_MD_CTX_new",
                   "EVP_PKEY_new_raw_private_key",
                   "EVP_PKEY_new_raw_public_key"):
            getattr(lib, fn).restype = ctypes.c_void_p
        lib.EVP_PKEY_new_raw_private_key.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.EVP_PKEY_new_raw_public_key.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        for fn in ("EVP_CIPHER_CTX_free", "EVP_MD_CTX_free", "EVP_PKEY_free"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class InvalidTag(Exception):
    """AEAD authentication failure (cryptography.exceptions.InvalidTag)."""


def _check(ok, what: str):
    if not ok:
        raise ValueError(f"libcrypto: {what} failed")


class _EvpCipher:
    """One EVP_CIPHER_CTX pass (encrypt or decrypt direction)."""

    def __init__(self, cipher, key: bytes, iv: bytes, encrypt: bool,
                 gcm: bool = False):
        lib = _libcrypto()
        self._lib = lib
        self.ctx = lib.EVP_CIPHER_CTX_new()
        _check(self.ctx, "EVP_CIPHER_CTX_new")
        self.encrypt = encrypt
        init = lib.EVP_EncryptInit_ex if encrypt else lib.EVP_DecryptInit_ex
        ctx = ctypes.c_void_p(self.ctx)
        _check(init(ctx, ctypes.c_void_p(cipher), None, None, None), "init")
        if gcm and len(iv) != 12:  # GCM's default nonce length is 12
            _check(lib.EVP_CIPHER_CTX_ctrl(
                ctx, _EVP_CTRL_GCM_SET_IVLEN, len(iv), None), "set ivlen")
        _check(init(ctx, None, None, key, iv), "key/iv init")

    def ctrl(self, op: int, arg: int, buf) -> None:
        _check(self._lib.EVP_CIPHER_CTX_ctrl(
            ctypes.c_void_p(self.ctx), op, arg, buf), "ctrl")

    def update(self, data: bytes, aad: bool = False) -> bytes:
        out = None if aad else ctypes.create_string_buffer(len(data) + 16)
        outl = ctypes.c_int(0)
        fn = (self._lib.EVP_EncryptUpdate if self.encrypt
              else self._lib.EVP_DecryptUpdate)
        _check(fn(ctypes.c_void_p(self.ctx), out, ctypes.byref(outl),
                  data, len(data)), "update")
        return b"" if aad else out.raw[:outl.value]

    def final(self) -> bool:
        out = ctypes.create_string_buffer(16)
        outl = ctypes.c_int(0)
        fn = (self._lib.EVP_EncryptFinal_ex if self.encrypt
              else self._lib.EVP_DecryptFinal_ex)
        return bool(fn(ctypes.c_void_p(self.ctx), out, ctypes.byref(outl)))

    def __del__(self):
        if getattr(self, "ctx", None):
            self._lib.EVP_CIPHER_CTX_free(ctypes.c_void_p(self.ctx))
            self.ctx = None


class AESGCM:
    """Drop-in for ``cryptography``'s AESGCM (16-byte tag appended)."""

    def __init__(self, key: bytes):
        if len(key) not in (16, 24, 32):
            raise ValueError("AES key must be 128/192/256 bits")
        self._key = bytes(key)

    def _cipher(self):
        lib = _libcrypto()
        return {16: lib.EVP_aes_128_gcm, 24: lib.EVP_aes_192_gcm,
                32: lib.EVP_aes_256_gcm}[len(self._key)]()

    def encrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        c = _EvpCipher(self._cipher(), self._key, bytes(nonce), encrypt=True,
                       gcm=True)
        if aad:
            c.update(bytes(aad), aad=True)
        ct = c.update(bytes(data))
        _check(c.final(), "gcm final")
        tag = ctypes.create_string_buffer(_TAG_LEN)
        c.ctrl(_EVP_CTRL_GCM_GET_TAG, _TAG_LEN, tag)
        return ct + tag.raw[:_TAG_LEN]

    def decrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        data = bytes(data)
        if len(data) < _TAG_LEN:
            raise InvalidTag("ciphertext shorter than the GCM tag")
        ct, tag = data[:-_TAG_LEN], data[-_TAG_LEN:]
        c = _EvpCipher(self._cipher(), self._key, bytes(nonce), encrypt=False,
                       gcm=True)
        if aad:
            c.update(bytes(aad), aad=True)
        plain = c.update(ct)
        c.ctrl(_EVP_CTRL_GCM_SET_TAG, _TAG_LEN,
               ctypes.create_string_buffer(tag, _TAG_LEN))
        if not c.final():
            raise InvalidTag("GCM tag verification failed")
        return plain


class ChaCha20:
    """Algorithm marker mirroring ``ciphers.algorithms.ChaCha20``."""

    def __init__(self, key: bytes, nonce: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20 key must be 32 bytes")
        if len(nonce) != 16:
            raise ValueError("ChaCha20 nonce must be 16 bytes")
        self.key = bytes(key)
        self.nonce = bytes(nonce)


class _ChaChaEncryptor:
    def __init__(self, algorithm: ChaCha20):
        self._c = _EvpCipher(_libcrypto().EVP_chacha20(), algorithm.key,
                             algorithm.nonce, encrypt=True)

    def update(self, data: bytes) -> bytes:
        return self._c.update(bytes(data))


class Cipher:
    """Just enough of ``ciphers.Cipher`` for the ChaCha20 keystream use."""

    def __init__(self, algorithm, mode=None):
        if not isinstance(algorithm, ChaCha20):
            raise TypeError("compat Cipher only supports ChaCha20")
        self._algorithm = algorithm

    def encryptor(self) -> _ChaChaEncryptor:
        return _ChaChaEncryptor(self._algorithm)


# --- Ed25519 (EVP_PKEY one-shot DigestSign/DigestVerify) --------------------


class _Pkey:
    def __init__(self, ptr):
        self._lib = _libcrypto()
        self.ptr = ptr

    def __del__(self):
        if getattr(self, "ptr", None):
            self._lib.EVP_PKEY_free(ctypes.c_void_p(self.ptr))
            self.ptr = None


class Ed25519PublicKey:
    def __init__(self, pkey: _Pkey, raw: bytes):
        self._pkey = pkey
        self._raw = raw

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "Ed25519PublicKey":
        data = bytes(data)
        ptr = _libcrypto().EVP_PKEY_new_raw_public_key(
            _EVP_PKEY_ED25519, None, data, len(data))
        if not ptr:
            raise ValueError("invalid Ed25519 public key")
        return cls(_Pkey(ptr), data)

    def public_bytes(self, encoding=None, format=None) -> bytes:
        return self._raw

    def verify(self, signature: bytes, data: bytes) -> None:
        lib = _libcrypto()
        ctx = lib.EVP_MD_CTX_new()
        _check(ctx, "EVP_MD_CTX_new")
        try:
            _check(lib.EVP_DigestVerifyInit(
                ctypes.c_void_p(ctx), None, None, None,
                ctypes.c_void_p(self._pkey.ptr)), "verify init")
            ok = lib.EVP_DigestVerify(
                ctypes.c_void_p(ctx), bytes(signature), len(signature),
                bytes(data), len(data))
            if ok != 1:
                raise InvalidSignature("Ed25519 verification failed")
        finally:
            lib.EVP_MD_CTX_free(ctypes.c_void_p(ctx))


class Ed25519PrivateKey:
    def __init__(self, pkey: _Pkey):
        self._pkey = pkey

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls.from_private_bytes(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "Ed25519PrivateKey":
        data = bytes(data)
        ptr = _libcrypto().EVP_PKEY_new_raw_private_key(
            _EVP_PKEY_ED25519, None, data, len(data))
        if not ptr:
            raise ValueError("invalid Ed25519 private key")
        return cls(_Pkey(ptr))

    def public_key(self) -> Ed25519PublicKey:
        lib = _libcrypto()
        buf = ctypes.create_string_buffer(32)
        ln = ctypes.c_size_t(32)
        _check(lib.EVP_PKEY_get_raw_public_key(
            ctypes.c_void_p(self._pkey.ptr), buf, ctypes.byref(ln)),
            "get raw public key")
        return Ed25519PublicKey.from_public_bytes(buf.raw[:ln.value])

    def sign(self, data: bytes) -> bytes:
        lib = _libcrypto()
        ctx = lib.EVP_MD_CTX_new()
        _check(ctx, "EVP_MD_CTX_new")
        try:
            _check(lib.EVP_DigestSignInit(
                ctypes.c_void_p(ctx), None, None, None,
                ctypes.c_void_p(self._pkey.ptr)), "sign init")
            sig = ctypes.create_string_buffer(64)
            ln = ctypes.c_size_t(64)
            _check(lib.EVP_DigestSign(
                ctypes.c_void_p(ctx), sig, ctypes.byref(ln),
                bytes(data), len(data)), "sign")
            return sig.raw[:ln.value]
        finally:
            lib.EVP_MD_CTX_free(ctypes.c_void_p(ctx))


class InvalidSignature(Exception):
    """cryptography.exceptions.InvalidSignature analog."""


# --- HKDF-SHA256 (RFC 5869 over hmac/hashlib) -------------------------------


class _SHA256:
    digest_size = 32


class hashes:  # namespace mirror of cryptography.hazmat.primitives.hashes
    SHA256 = _SHA256


class _Raw:
    Raw = "raw"


class serialization:  # namespace mirror (only Raw/Raw is used)
    Encoding = _Raw
    PublicFormat = _Raw


class HKDF:
    def __init__(self, algorithm=None, length: int = 32, salt=None,
                 info: bytes = b""):
        self.length = length
        self.salt = salt or b"\x00" * 32
        self.info = bytes(info or b"")

    def derive(self, key_material: bytes) -> bytes:
        prk = hmac.new(self.salt, bytes(key_material), hashlib.sha256).digest()
        okm = b""
        block = b""
        counter = 1
        while len(okm) < self.length:
            block = hmac.new(prk, block + self.info + bytes([counter]),
                             hashlib.sha256).digest()
            okm += block
            counter += 1
        return okm[:self.length]
