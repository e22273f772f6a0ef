"""The port's copies of the host codecs vs the JAX package's: wire
encodings, the binary codec, ``KeyManager``, the recovery phrases, the
AEAD and zstd give the same bytes.

The card's machine has no ``cryptography`` wheel, so the port runs there
on its libcrypto shim (``utils/compat_crypto.py``).  The ``compat``
fixture forces the port onto the shim here, where the reference keeps
``cryptography``: keys, signatures and packfile bytes must still agree.
"""

import random

import pytest

from backuwup_tpu import crypto as ref_crypto
from backuwup_tpu import wire as ref_wire
from backuwup_tpu import wordlist as ref_wordlist
from backuwup_tpu.snapshot import packfile as ref_packfile
from backuwup_tpu.utils import serialization as ref_serialization
from backuwup_tpu.utils import zstd as ref_zstd
from backuwup_tpu_torch import crypto, wire, wordlist
from backuwup_tpu_torch.ops.blake3_cpu import blake3_many
from backuwup_tpu_torch.snapshot import blob_index, packfile
from backuwup_tpu_torch.utils import compat_crypto, serialization, zstd

SECRETS = [bytes(range(32)), b"\x07" * 32, b"\xff" * 31 + b"\x00"]


@pytest.fixture(params=["default", "compat"])
def compat(request, monkeypatch):
    """The port on its default crypto imports, or forced onto the
    libcrypto shim (every name ``crypto.py``, ``packfile.py`` and
    ``blob_index.py`` take from ``cryptography``)."""
    if request.param == "compat":
        for name in ("Cipher", "ChaCha20", "Ed25519PrivateKey",
                     "Ed25519PublicKey", "HKDF", "hashes", "serialization"):
            monkeypatch.setattr(crypto, name, getattr(compat_crypto, name))
        monkeypatch.setattr(packfile, "AESGCM", compat_crypto.AESGCM)
        monkeypatch.setattr(blob_index, "AESGCM", compat_crypto.AESGCM)
    return request.param


# --- wire ---------------------------------------------------------------------


def test_wire_constants_and_enums_equal():
    names = [n for n in dir(ref_wire) if n.endswith("_LEN")]
    assert names and all(getattr(wire, n) == getattr(ref_wire, n)
                         for n in names)
    for enum in ("BlobKind", "CompressionKind", "TreeKind"):
        assert {m.name: int(m) for m in getattr(wire, enum)} == \
            {m.name: int(m) for m in getattr(ref_wire, enum)}


def _tree(w, kind, name, n_children, sibling):
    return w.Tree(
        kind=getattr(w.TreeKind, kind), name=name,
        metadata=w.TreeMetadata(size=123, mtime_ns=10 ** 18, ctime_ns=42),
        children=[bytes([i % 256] * 32) for i in range(n_children)],
        next_sibling=b"\xaa" * 32 if sibling else None)


@pytest.mark.parametrize("kind,name,n_children,sibling", [
    ("DIR", "", 0, False),
    ("DIR", "subdir", 3, True),
    ("FILE", "päth-ü.bin", 300, False),
    ("FILE", "x" * 255, 1, True),
])
def test_tree_encoding_identical(kind, name, n_children, sibling):
    enc = _tree(wire, kind, name, n_children, sibling).encode_bytes()
    assert enc == _tree(ref_wire, kind, name, n_children,
                        sibling).encode_bytes()
    # each package decodes the other's bytes to the same node
    for a, b in ((wire, ref_wire), (ref_wire, wire)):
        back = a.Tree.decode_bytes(enc)
        assert back.encode_bytes() == enc
        assert back.kind.name == kind and back.name == name
        assert b.Tree.decode_bytes(back.encode_bytes()).children == \
            back.children


def test_packfile_header_blob_and_codec_identical():
    out = []
    for w, ser in ((wire, serialization), (ref_wire, ref_serialization)):
        wr = ser.Writer()
        wr.u8(7)
        wr.u32(0xDEADBEEF)
        wr.u64(1 << 45)
        wr.blob(b"hello")
        wr.str("päth/ü")
        wr.opt_fixed(None, 32)
        wr.opt_fixed(b"\x01" * 32, 32)
        for i, kind in enumerate(w.BlobKind):
            w.PackfileHeaderBlob(
                hash=bytes([i]) * 32, kind=kind,
                compression=list(w.CompressionKind)[i % 3],
                length=1000 + i, offset=i << 20).encode(wr)
        out.append(wr.take())
    assert out[0] == out[1]
    r = serialization.Reader(out[1])
    assert (r.u8(), r.u32(), r.u64(), r.blob(), r.str()) == \
        (7, 0xDEADBEEF, 1 << 45, b"hello", "päth/ü")
    assert r.opt_fixed(32) is None and r.opt_fixed(32) == b"\x01" * 32
    for i, kind in enumerate(ref_wire.BlobKind):
        e = wire.PackfileHeaderBlob.decode(r)
        assert (e.hash, int(e.kind), e.length, e.offset) == \
            (bytes([i]) * 32, int(kind), 1000 + i, i << 20)
    r.expect_end()
    with pytest.raises(serialization.CodecError):
        serialization.Reader(b"\x01\x02").u64()


# --- crypto -------------------------------------------------------------------


@pytest.mark.parametrize("secret", SECRETS)
def test_key_manager_agrees(compat, secret):
    km = crypto.KeyManager.from_secret(secret)
    ref = ref_crypto.KeyManager.from_secret(secret)
    assert km.client_id == ref.client_id
    assert km.backup_secret == ref.backup_secret
    for info in (b"header", b"index", b"audit", b"\xaa" * 32, b""):
        assert km.derive_backup_key(info) == ref.derive_backup_key(info)
        assert crypto.hkdf_derive(km.backup_secret, info, 17) == \
            ref_crypto.hkdf_derive(ref.backup_secret, info, 17)
    msg = b"storage request 12345"
    sig = km.sign(msg)
    assert sig == ref.sign(msg)  # Ed25519 signatures are deterministic
    assert crypto.verify_signature(ref.client_id, msg, sig)
    assert ref_crypto.verify_signature(km.client_id, msg, sig)
    assert not crypto.verify_signature(km.client_id, msg + b"x", sig)


@pytest.mark.parametrize("secret", SECRETS)
def test_recovery_phrases_agree(secret):
    phrase = crypto.secret_to_phrase(secret)
    words = crypto.secret_to_words(secret)
    assert phrase == ref_crypto.secret_to_phrase(secret)
    assert words == ref_crypto.secret_to_words(secret)
    assert ref_crypto.phrase_to_secret(phrase) == secret
    assert crypto.words_to_secret(words) == secret
    assert crypto.parse_recovery(words) == \
        ref_crypto.parse_recovery(words) == secret
    assert crypto.parse_recovery(phrase.upper().replace("1", "l")) == secret
    corrupted = ("7" if phrase[0] != "7" else "8") + phrase[1:]
    with pytest.raises(ValueError):
        crypto.phrase_to_secret(corrupted)


def test_wordlist_identical():
    assert wordlist.WORDS == ref_wordlist.WORDS
    assert len(wordlist.WORD_INDEX) == 2048


def test_compat_aead_matches_reference_aead():
    rng = random.Random(5)
    for n in (0, 1, 16, 1000, 1 << 16):
        key, nonce = rng.randbytes(32), rng.randbytes(12)
        data, aad = rng.randbytes(n), rng.randbytes(n % 7)
        ct = compat_crypto.AESGCM(key).encrypt(nonce, data, aad)
        assert ct == ref_packfile.AESGCM(key).encrypt(nonce, data, aad)
        assert ref_packfile.AESGCM(key).decrypt(nonce, ct, aad) == data
        bad = bytearray(ct)
        bad[-1] ^= 1
        with pytest.raises(Exception):
            compat_crypto.AESGCM(key).decrypt(nonce, bytes(bad), aad)


def test_codec_identical():
    """The packfile codec each package picks (libzstd, else zlib) and its
    bytes."""
    assert zstd.available() == ref_zstd.available()
    rng = random.Random(6)
    for data in (b"", b"a" * 100_000, rng.randbytes(70_000)):
        kind, enc = packfile._compress(data)
        ref_kind, ref_enc = ref_packfile._compress(data)
        assert (int(kind), enc) == (int(ref_kind), ref_enc)
        assert ref_packfile._decompress(ref_kind, enc) == data
        assert packfile._decompress(kind, ref_enc) == data


def test_packfile_bytes_agree_on_either_aead(compat, tmp_path, monkeypatch):
    """A packfile the port seals (on its default AEAD or on the shim) is
    byte-identical to the reference's, and each package opens the
    other's."""
    rng = random.Random(7)
    datas = [rng.randbytes(n) for n in (10, 5000, 300_000)] + [b"x" * 4096]
    hashes = blake3_many(datas)
    ids = []
    for pf, w, km in ((packfile, wire, crypto.KeyManager),
                      (ref_packfile, ref_wire, ref_crypto.KeyManager)):
        monkeypatch.setattr(pf.os, "urandom", random.Random(8).randbytes)
        written = []
        writer = pf.PackfileWriter(
            km.from_secret(SECRETS[0]), tmp_path / pf.__name__,
            on_packfile=lambda pid, path, hs, size: written.append(
                (pid, path)))
        for h, d in zip(hashes, datas):
            writer.add_blob(w.Blob(hash=h, kind=w.BlobKind.FILE_CHUNK,
                                   data=d))
        writer.flush()
        writer.close()
        ids.append(written)
    (pid, path), (ref_pid, ref_path) = ids[0][0], ids[1][0]
    assert len(ids[0]) == len(ids[1]) == 1 and pid == ref_pid
    assert path.read_bytes() == ref_path.read_bytes()
    for pf, km, d in ((packfile, crypto.KeyManager, ref_path.parent.parent),
                      (ref_packfile, ref_crypto.KeyManager,
                       path.parent.parent)):
        reader = pf.PackfileReader(km.from_secret(SECRETS[0]), d)
        assert [b.data for b in reader.iter_blobs(pid)] == datas
