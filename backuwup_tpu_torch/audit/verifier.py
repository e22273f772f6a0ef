"""Verifier side: pick single-use challenges, judge the proof batch.

Counterpart of ``backuwup_tpu/audit/verifier.py``, copied over the port's
``Store``, ``ChallengeTable`` and ``wire``.

Challenge consumption is crash-safe by construction: the per-packfile
cursor in the store advances the moment entries are selected, BEFORE the
challenges leave the machine, so no table entry is ever sent twice — even
if the round dies mid-flight.  A replayed or reordered proof therefore
never matches a live expectation (and the transport's session-nonce +
sequence header already drops stale frames before they get here).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from .. import defaults
from ..snapshot.blob_index import ChallengeTable
from ..store import Store
from ..wire import ProofStatus, StorageChallenge, StorageProof
from .challenge import to_wire


@dataclass(frozen=True)
class AuditResult:
    """Outcome of one audit round against one peer."""

    passed: bool
    checked: int
    detail: str = ""


def select_challenges(
        store: Store, tables: ChallengeTable, peer_id: bytes,
        samples: int = defaults.AUDIT_SAMPLES_PER_ROUND,
) -> Tuple[List[StorageChallenge], List[bytes]]:
    """Draw up to ``samples`` unused table entries across everything the
    peer holds, round-robin over packfiles so one big packfile cannot
    starve the rest.  Returns (wire challenges, expected digests).

    A placement with shard_index >= 0 is audited under its 13-byte shard
    id (erasure/stripe.py) — the challenge table, cursor, and the
    prover's on-disk file are all keyed by that id."""
    held = [pid if idx < 0 else pid + bytes([idx])
            for pid, _, idx in store.shard_placements_for_peer(peer_id)]
    pools = []
    for pid in held:
        if not tables.has(pid):
            continue
        entries = tables.load(pid)
        cursor = store.get_audit_cursor(pid)
        if cursor < len(entries):
            pools.append([pid, entries, cursor])
    challenges: List[StorageChallenge] = []
    expected: List[bytes] = []
    while pools and len(challenges) < samples:
        for pool in list(pools):
            pid, entries, cursor = pool
            entry = entries[cursor]
            challenges.extend(to_wire(pid, [entry]))
            expected.append(entry.digest)
            pool[2] = cursor + 1
            store.set_audit_cursor(pid, pool[2])  # burn before sending
            if pool[2] >= len(entries):
                pools.remove(pool)
            if len(challenges) >= samples:
                break
    return challenges, expected


def check_proofs(challenges: Sequence[StorageChallenge],
                 expected: Sequence[bytes],
                 proofs: Sequence[StorageProof]) -> AuditResult:
    """Judge a proof batch positionally: proof i answers challenge i."""
    if len(proofs) != len(challenges):
        return AuditResult(
            passed=False, checked=len(proofs),
            detail=f"answered {len(proofs)}/{len(challenges)} challenges")
    failures = []
    for c, want, p in zip(challenges, expected, proofs):
        if bytes(p.packfile_id) != bytes(c.packfile_id):
            failures.append(f"{bytes(c.packfile_id).hex()[:8]}: wrong packfile"
                            " in proof")
        elif p.status != ProofStatus.OK:
            failures.append(f"{bytes(c.packfile_id).hex()[:8]}:"
                            f" {p.status.name.lower()}")
        elif bytes(p.digest) != bytes(want):
            failures.append(f"{bytes(c.packfile_id).hex()[:8]}: digest"
                            f" mismatch @{c.offset}+{c.length}")
    if failures:
        return AuditResult(passed=False, checked=len(challenges),
                           detail="; ".join(failures))
    return AuditResult(passed=True, checked=len(challenges))
