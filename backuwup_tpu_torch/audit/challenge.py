"""Challenge-table construction: precompute audit probes at pack time.

Counterpart of ``backuwup_tpu/audit/challenge.py``, copied over the port's
backend (``digest_many``), ``ChallengeEntry`` and ``wire``.

The verifier cannot recompute window digests later — its plaintext
packfiles are deleted as soon as a peer acks them (``send.rs:277-289``
semantics) — so every future challenge must be decided, and its expected
answer hashed, while the bytes are still local.  That is exactly the
precomputed-token construction of Juels & Kaliski (PORs, CCS 2007 §3):
each table entry is single-use, consumed in order by a cursor the store
tracks per packfile.

The whole table is hashed in ONE ``backend.digest_many`` batch, so on the
TPU backend pack-time audit prep rides the same device dispatch as chunk
fingerprinting (``ops/digest_pool.py``).
"""

from __future__ import annotations

import os
from typing import List, Sequence

from .. import defaults
from ..snapshot.blob_index import ChallengeEntry
from ..wire import AUDIT_NONCE_LEN, StorageChallenge


def sample_windows(size: int, count: int,
                   window: int = defaults.AUDIT_WINDOW_BYTES,
                   rand=os.urandom) -> List[tuple]:
    """``count`` uniform random (offset, length) windows over ``size`` bytes.

    Length is clamped to the file, offsets are uniform over the valid
    range, so every byte of the packfile is sampled with equal probability
    — the uniformity the detection bound in docs/audit.md relies on.
    """
    if size <= 0:
        raise ValueError("cannot sample windows of an empty packfile")
    length = min(window, size)
    span = size - length + 1
    out = []
    for _ in range(count):
        offset = int.from_bytes(rand(8), "little") % span
        out.append((offset, length))
    return out


def build_challenge_table(backend, data: bytes,
                          count: int = defaults.AUDIT_CHALLENGES_PER_PACKFILE,
                          window: int = defaults.AUDIT_WINDOW_BYTES,
                          rand=os.urandom) -> List[ChallengeEntry]:
    """Precompute ``count`` single-use challenges over packfile ``data``.

    Each entry keys its digest with a fresh random nonce so a peer cannot
    precompute answers, dedup windows, or replay another verifier's
    transcript: digest = blake3(nonce || window-bytes), all entries hashed
    in one batched device call.
    """
    windows = sample_windows(len(data), count, window, rand)
    nonces = [rand(AUDIT_NONCE_LEN) for _ in windows]
    pieces = [n + data[off:off + ln] for n, (off, ln) in zip(nonces, windows)]
    digests = backend.digest_many(pieces)
    return [ChallengeEntry(offset=off, length=ln, nonce=n, digest=d)
            for (off, ln), n, d in zip(windows, nonces, digests)]


def to_wire(packfile_id: bytes,
            entries: Sequence[ChallengeEntry]) -> tuple:
    """Strip expected digests: what actually goes to the prover."""
    return tuple(StorageChallenge(packfile_id=bytes(packfile_id),
                                  offset=e.offset, length=e.length,
                                  nonce=e.nonce)
                 for e in entries)


def detection_probability(sampled_fraction: float, n: int) -> float:
    """P(detect) = 1 - (1 - f)^n for n independent uniform windows when a
    fraction f of the file's bytes is corrupt/missing (docs/audit.md)."""
    return 1.0 - (1.0 - sampled_fraction) ** n
