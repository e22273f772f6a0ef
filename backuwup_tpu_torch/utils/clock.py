"""The clock seam: one injection point for every time-dependent path.

Counterpart of ``backuwup_tpu/utils/clock.py``, copied so that the port
imports nothing of the JAX package.

The reference's simulation plane (``sim/``) runs the *real* retry,
matchmaking, peer-stats, and durability-sweep code on virtual time — a
simulated week of million-client churn in tier-1 minutes.  That only
works if the real code never reaches for the wall clock directly: every
``time.time()`` / ``time.monotonic()`` / ``asyncio.sleep()`` in a
sim-covered module routes through a :class:`Clock` handed in at
construction (bkwlint BKW006 enforces this statically).

The contract is three methods:

* ``now()`` — wall-clock epoch seconds.  Comparable to *persisted*
  timestamps (``last_seen``, ``sent_at``, audit-ledger ``next_due``), so
  anything that judges stored state against the present uses it.
* ``monotonic()`` — never steps backward.  Anything measuring an
  *interval* (violation-seconds accrual, rate math) uses it so an NTP
  step can neither inflate nor hide elapsed time.  ``SimClock`` keeps
  ``now == monotonic`` — virtual time only moves forward.
* ``await sleep(delay)`` — parks the caller until ``delay`` seconds of
  *clock* time pass.  Under asyncio that is ``asyncio.sleep``; under the
  sim driver it parks the task on the virtual deadline heap.

:data:`SYSTEM` is the process-wide real-time instance and the default
everywhere, so production call sites change shape only by gaining an
optional ``clock=`` parameter.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional


class SystemClock:
    """Real time: the production implementation of the clock seam.

    This class is the seam's terminal — the one place in the sim-covered
    modules where the actual wall clock is read (BKW006 baselines these
    three call sites, nothing else).
    """

    def now(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)


#: The process-wide real-time clock; ``resolve(None)`` returns it.
SYSTEM = SystemClock()


def resolve(clock: Optional[object]) -> object:
    """``clock or SYSTEM`` with an explicit name, so constructors read as
    declaring the seam rather than defaulting an argument."""
    return SYSTEM if clock is None else clock
