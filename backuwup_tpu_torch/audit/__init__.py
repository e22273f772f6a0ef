"""Storage attestation: challenge-response audits of peer-held packfiles.

Counterpart of ``backuwup_tpu/audit``, copied so that the port imports
nothing of the JAX package.

No reference equivalent — the thesis flags undetected data loss at peers
as the open risk of storage-for-storage trading.  This subsystem closes it
with PoR-style random-window audits (Juels & Kaliski, CCS 2007; Shacham &
Waters, ASIACRYPT 2008): the verifier samples random (packfile, offset,
length) windows, the prover answers with keyed BLAKE3 digests computed in
one device batch over the existing digest pipeline, and outcomes feed a
per-peer ledger that demotes unreliable peers out of the free-space
ordering.  See docs/audit.md for the protocol and sampling math.
"""

from .challenge import build_challenge_table, detection_probability
from .ledger import record_fail, record_miss, record_pass
from .prover import compute_proofs
from .verifier import AuditResult, check_proofs, select_challenges

__all__ = [
    "AuditResult",
    "build_challenge_table",
    "check_proofs",
    "compute_proofs",
    "detection_probability",
    "record_fail",
    "record_miss",
    "record_pass",
    "select_challenges",
]
