"""Audit ledger policy: pass/fail/miss accounting, backoff, demotion.

Counterpart of ``backuwup_tpu/audit/ledger.py``, copied over the port's
``Store`` and retry policy (``utils/retry.py``).

Three outcomes, three severities:

* **pass** — proofs all matched.  Counters reset, peer is (re-)promoted,
  next audit after the normal interval.
* **fail** — the peer ANSWERED and the answer proves data loss (bad
  digest, missing/short file).  Demotes after
  ``AUDIT_DEMOTE_FAILURES`` consecutive failures (default 1: a proven
  corruption is immediately disqualifying).
* **miss** — the peer could not be reached during its window.  Offline is
  normal for a desktop P2P fleet, so misses demote only after
  ``AUDIT_DEMOTE_MISSES`` consecutive windows, with exponential backoff
  between retries so a long-dead peer costs ~O(log) audit attempts.

Demoted peers drop out of ``Store.find_peers_with_storage`` — the
free-space ordering new packfiles are matched against — but their ledger
history survives, and a later pass re-promotes them.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Optional

from .. import defaults
from ..store import AuditState, Store
from ..utils import retry


def _backoff(consecutive: int) -> float:
    # the unified retry policy (utils/retry.py); AUDIT pins jitter=0 so the
    # persisted next_due schedule stays exactly predictable
    return retry.AUDIT.delay_s(consecutive)


def record_pass(store: Store, peer: bytes,
                now: Optional[float] = None) -> AuditState:
    now = time.time() if now is None else now
    st = store.get_audit_state(peer)
    st = replace(st, passes=st.passes + 1, consecutive_failures=0,
                 consecutive_misses=0, demoted=False, last_result="pass",
                 last_audit=now, next_due=now + defaults.AUDIT_INTERVAL_S)
    store.put_audit_state(st)
    return st


def record_fail(store: Store, peer: bytes, detail: str = "",
                now: Optional[float] = None) -> AuditState:
    now = time.time() if now is None else now
    st = store.get_audit_state(peer)
    consecutive = st.consecutive_failures + 1
    st = replace(st, failures=st.failures + 1,
                 consecutive_failures=consecutive, consecutive_misses=0,
                 demoted=(st.demoted
                          or consecutive >= defaults.AUDIT_DEMOTE_FAILURES),
                 last_result=f"fail: {detail}" if detail else "fail",
                 last_audit=now, next_due=now + _backoff(consecutive))
    store.put_audit_state(st)
    return st


def record_miss(store: Store, peer: bytes,
                now: Optional[float] = None) -> AuditState:
    now = time.time() if now is None else now
    st = store.get_audit_state(peer)
    consecutive = st.consecutive_misses + 1
    st = replace(st, misses=st.misses + 1, consecutive_misses=consecutive,
                 demoted=(st.demoted
                          or consecutive >= defaults.AUDIT_DEMOTE_MISSES),
                 last_result="miss", last_audit=now,
                 next_due=now + _backoff(consecutive))
    store.put_audit_state(st)
    return st
