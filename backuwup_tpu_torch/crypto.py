"""Crypto & identity: root secret -> every key in the system.

Counterpart of ``backuwup_tpu/crypto.py``, copied so that the port imports
nothing of the JAX package; what it writes is byte-identical.

Re-designs the reference key manager (``client/src/key_manager.rs:32-87``)
and mnemonic identity flow (``client/src/ui/cli.rs:26-77``):

* A single 32-byte **root secret** seeds a ChaCha20 deterministic stream;
  the first 32 bytes become the Ed25519 signing seed (the public key doubles
  as the client identity, ``shared/src/types.rs:4-10``), the next 32 the
  symmetric **backup secret**.
* Every content key is derived from the backup secret with HKDF-SHA256 and a
  context string (``key_manager.rs:80-86``): per-blob keys use the blob hash
  as context, the packfile-header key uses ``b"header"``, the index key
  ``b"index"`` (``packfile/pack.rs:58-79``, ``blob_index.rs:16-19``).
* The root secret round-trips through a human-readable **recovery phrase**
  in two equivalent forms, both accepted on restore: a 24-word mnemonic
  from an embedded 2048-word list (the reference prints a BIP39 mnemonic,
  ``cli.rs:55-77``; the wordlist is vendored in-package so restore never
  depends on an external file) and a Crockford-base32 group code with a
  checksum (canonical/compact form).

Host-side only: crypto is I/O-path work, not device compute (SURVEY.md §2.4).
"""

from __future__ import annotations

import hmac
import os
from dataclasses import dataclass

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers import Cipher
    from cryptography.hazmat.primitives.ciphers.algorithms import ChaCha20
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
except ModuleNotFoundError:  # containers without the wheel: libcrypto shim
    from .utils.compat_crypto import (
        Cipher,
        ChaCha20,
        Ed25519PrivateKey,
        Ed25519PublicKey,
        HKDF,
        hashes,
        serialization,
    )

ROOT_SECRET_LEN = 32
KEY_LEN = 32


def _chacha_stream(seed: bytes, length: int) -> bytes:
    """Deterministic expansion of the root secret (CSPRNG analog of the
    reference's seeded rand_chacha, ``key_manager.rs:42-49``)."""
    cipher = Cipher(ChaCha20(seed, b"\x00" * 16), mode=None)
    return cipher.encryptor().update(b"\x00" * length)


def hkdf_derive(secret: bytes, info: bytes, length: int = KEY_LEN) -> bytes:
    """HKDF-SHA256(extract(no salt) || expand(info)) — key_manager.rs:80-86."""
    return HKDF(algorithm=hashes.SHA256(), length=length, salt=None,
                info=info).derive(secret)


@dataclass(frozen=True)
class KeyManager:
    """All client keys, deterministically derived from the root secret."""

    root_secret: bytes
    signing_key: Ed25519PrivateKey
    backup_secret: bytes

    @classmethod
    def generate(cls) -> "KeyManager":
        return cls.from_secret(os.urandom(ROOT_SECRET_LEN))

    @classmethod
    def from_secret(cls, root_secret: bytes) -> "KeyManager":
        if len(root_secret) != ROOT_SECRET_LEN:
            raise ValueError("root secret must be 32 bytes")
        stream = _chacha_stream(root_secret, 64)
        signing_key = Ed25519PrivateKey.from_private_bytes(stream[:32])
        return cls(root_secret=bytes(root_secret), signing_key=signing_key,
                   backup_secret=stream[32:64])

    @property
    def client_id(self) -> bytes:
        """32-byte Ed25519 public key == identity (types.rs:4-10)."""
        return self.signing_key.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)

    def sign(self, message: bytes) -> bytes:
        return self.signing_key.sign(bytes(message))

    def derive_backup_key(self, info: bytes, length: int = KEY_LEN) -> bytes:
        return hkdf_derive(self.backup_secret, bytes(info), length)


def verify_signature(client_id: bytes, message: bytes, signature: bytes) -> bool:
    """Ed25519 verify; mirrors ``verify_strict`` use at every trust boundary
    (``net_p2p/handle_connections.rs:194-204``, server
    ``client_auth_manager.rs:74-78``)."""
    try:
        Ed25519PublicKey.from_public_bytes(bytes(client_id)).verify(
            bytes(signature), bytes(message))
        return True
    except Exception:
        return False


# --------------------------------------------------------------------------
# Recovery phrase: Crockford-base32 groups + checksum (BIP39-mnemonic analog)
# --------------------------------------------------------------------------

_B32 = "0123456789abcdefghjkmnpqrstvwxyz"  # Crockford (no i, l, o, u)
_B32_INV = {c: i for i, c in enumerate(_B32)}
_B32_INV.update({"i": 1, "l": 1, "o": 0})  # transcription forgiveness
_CHECK_LEN = 4
_GROUP = 8


def _check_tag(secret: bytes) -> bytes:
    return hmac.new(b"backuwup-recovery-v1", secret, "sha256").digest()


def _checksum(secret: bytes) -> str:
    v = int.from_bytes(_check_tag(secret)[:4], "big")
    return "".join(_B32[(v >> (5 * i)) & 31] for i in range(_CHECK_LEN))


def secret_to_phrase(secret: bytes) -> str:
    """32-byte secret -> 7 dash-separated groups (52 data + 4 check chars)."""
    if len(secret) != ROOT_SECRET_LEN:
        raise ValueError("root secret must be 32 bytes")
    v = int.from_bytes(secret, "big")
    chars = "".join(_B32[(v >> (5 * i)) & 31] for i in range(52))  # 260 bits
    chars += _checksum(secret)
    return "-".join(chars[i:i + _GROUP] for i in range(0, len(chars), _GROUP))


def phrase_to_secret(phrase: str) -> bytes:
    """Inverse of :func:`secret_to_phrase`; raises ValueError on typos."""
    chars = phrase.strip().lower().replace("-", "").replace(" ", "")
    if len(chars) != 52 + _CHECK_LEN:
        raise ValueError("recovery phrase must have 56 characters")
    try:
        digits = [_B32_INV[c] for c in chars]
    except KeyError as e:
        raise ValueError(f"invalid character in recovery phrase: {e}") from None
    v = 0
    for i, d in enumerate(digits[:52]):
        v |= d << (5 * i)
    if v >= 1 << 256:
        raise ValueError("recovery phrase out of range")
    secret = v.to_bytes(32, "big")
    if "".join(_B32[d] for d in digits[52:]) != _checksum(secret):
        raise ValueError("recovery phrase checksum mismatch")
    return secret


# --------------------------------------------------------------------------
# Recovery phrase, word form: 24 words from the embedded 2048-word list
# (the reference prints a BIP39 mnemonic via the bip39 crate, cli.rs:55-77;
# here the wordlist is vendored in-package, see wordlist.py beside this module)
# --------------------------------------------------------------------------

_WORD_BITS = 11
_WORD_COUNT = 24  # 264 bits = 256 secret + 8 checksum, the BIP39 shape


def secret_to_words(secret: bytes) -> str:
    """32-byte secret -> 24 space-separated words (word form of the phrase).

    Layout mirrors the base32 codec: little-endian 11-bit limbs of
    ``secret-int | checksum-byte << 256``.
    """
    if len(secret) != ROOT_SECRET_LEN:
        raise ValueError("root secret must be 32 bytes")
    from .wordlist import WORDS
    v = int.from_bytes(secret, "big") | _check_tag(secret)[4] << 256
    return " ".join(WORDS[(v >> (_WORD_BITS * i)) & 2047]
                    for i in range(_WORD_COUNT))


def _resolve_word(token: str, truncated: bool = False) -> int:
    """Word -> index; exact match, else unique >=4-char prefix (error
    tolerance for truncated transcriptions, BIP39's 4-letter convention).

    In a *truncated* phrase (one where some other token only resolved as
    a prefix) an exact match that is also a proper prefix of longer list
    words — ``bell`` vs ``belly``, ``cat`` vs ``catalog`` — is ambiguous:
    the transcriber may have cut either word down to it.  Full phrases
    keep resolving such words exactly, so round-trips never regress.
    """
    from .wordlist import WORD_INDEX, WORDS
    idx = WORD_INDEX.get(token)
    if idx is not None:
        if truncated and any(w != token and w.startswith(token)
                             for w in WORDS):
            raise ValueError(
                f"ambiguous word {token!r}: in a truncated phrase it may "
                "stand for itself or a longer word; spell it out in full")
        return idx
    if len(token) >= 4:
        hits = [i for i, w in enumerate(WORDS) if w.startswith(token)]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise ValueError(f"ambiguous word prefix: {token!r}")
    raise ValueError(
        f"unknown recovery word: {token!r} — not in this client's embedded "
        "wordlist; a BIP39 phrase from a different wallet or language "
        "cannot be imported here")


def words_to_secret(phrase: str) -> bytes:
    """Inverse of :func:`secret_to_words`; raises ValueError on typos."""
    from .wordlist import WORD_INDEX
    tokens = phrase.strip().lower().replace("-", " ").replace(",", " ").split()
    if len(tokens) != _WORD_COUNT:
        raise ValueError(f"word phrase must have {_WORD_COUNT} words "
                         f"(got {len(tokens)})")
    # truncation-style entry: at least one token is not a full list word,
    # so exact-but-prefix words elsewhere in the phrase become ambiguous
    truncated = any(tok not in WORD_INDEX for tok in tokens)
    v = 0
    for i, tok in enumerate(tokens):
        v |= _resolve_word(tok, truncated=truncated) << (_WORD_BITS * i)
    secret = (v & ((1 << 256) - 1)).to_bytes(32, "big")
    if v >> 256 != _check_tag(secret)[4]:
        raise ValueError(
            "word phrase checksum mismatch: this is not a phrase this "
            "client generated — a valid BIP39 phrase from another wallet "
            "uses a different checksum layout and cannot be imported")
    return secret


def parse_recovery(phrase: str) -> bytes:
    """Decode a recovery phrase in EITHER form (words or base32 groups).

    Tries the word form first (a base32 string can never resolve as 24
    list words), then the base32 form; surfaces the error of whichever
    form the input most resembles.
    """
    looks_wordy = len(phrase.split()) >= _WORD_COUNT // 2
    try:
        return words_to_secret(phrase)
    except ValueError as word_err:
        try:
            return phrase_to_secret(phrase)
        except ValueError as b32_err:
            raise ValueError(str(word_err if looks_wordy else b32_err)) \
                from None
