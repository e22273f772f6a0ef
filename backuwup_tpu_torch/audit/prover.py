"""Prover side: answer a challenge batch from the obfuscated store.

Counterpart of ``backuwup_tpu/audit/prover.py``, copied over the port's
``Store``, ``obfuscate`` (``net/p2p.py``), ``wire`` and backend.

The prover holds foreign packfiles XOR-obfuscated with its local 4-byte
key (``received_files_writer.rs:76-78`` idiom), so each sampled window is
read from disk (seek + short read — never the whole packfile), de-obfuscated
with the key rotated to the window's offset, and hashed as
blake3(nonce || window).  All OK windows go to the device in ONE
``backend.digest_many`` batch — the audit hot path is the same batched
digest dispatch backup itself uses.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

from ..net.p2p import obfuscate
from ..store import Store
from ..wire import (PACKFILE_ID_LEN, ProofStatus, StorageChallenge,
                    StorageProof)


def deobfuscate_window(data: bytes, key: bytes, offset: int) -> bytes:
    """Undo the repeating-XOR for a slice starting at ``offset`` of the
    original stream: rotate the 4-byte key by offset mod 4 and XOR."""
    r = offset % 4
    return obfuscate(data, key[r:] + key[:r])


def read_window(path: Path, offset: int, length: int) -> bytes:
    with path.open("rb") as f:
        f.seek(offset)
        return f.read(length)


def compute_proofs(store: Store, backend, verifier_id: bytes,
                   challenges: Sequence[StorageChallenge]) -> List[StorageProof]:
    """One StorageProof per challenge, in challenge order.

    MISSING when the packfile is gone, SHORT when it exists but cannot
    cover the challenged window — both are honest failure admissions that
    let the verifier distinguish data loss from transport trouble.
    """
    key = store.get_obfuscation_key()
    if key is None:
        raise ValueError("obfuscation key not initialized")
    base = store.received_dir(verifier_id)
    proofs: List[StorageProof] = [None] * len(challenges)  # type: ignore
    pieces = []
    piece_slots = []
    for i, c in enumerate(challenges):
        # 12-byte ids name whole packfiles, 13-byte ids name erasure
        # shards; ReceivedFilesWriter stores them in sibling subtrees
        cid = bytes(c.packfile_id)
        sub = "shard" if len(cid) == PACKFILE_ID_LEN + 1 else "pack"
        path = base / sub / cid.hex()
        if not path.is_file():
            proofs[i] = StorageProof(packfile_id=c.packfile_id,
                                     status=ProofStatus.MISSING)
            continue
        if path.stat().st_size < c.offset + c.length:
            proofs[i] = StorageProof(packfile_id=c.packfile_id,
                                     status=ProofStatus.SHORT)
            continue
        window = deobfuscate_window(read_window(path, c.offset, c.length),
                                    key, c.offset)
        pieces.append(bytes(c.nonce) + window)
        piece_slots.append(i)
    if pieces:
        for i, digest in zip(piece_slots, backend.digest_many(pieces)):
            c = challenges[i]
            proofs[i] = StorageProof(packfile_id=c.packfile_id,
                                     status=ProofStatus.OK,
                                     digest=bytes(digest))
    return proofs
