"""Unified retry policy: jittered exponential backoff with caps.

Counterpart of ``backuwup_tpu/utils/retry.py``, copied so that the port
imports nothing of the JAX package.  Its ``bkw_retry_attempts_total``
counter lives in the port's own metrics registry (``obs/metrics.py``).

One policy type for every transient-failure loop in the client — the p2p
dial path, the server-WS reconnect, the storage-request throttle, the
send-loop pacing, and the audit ledger's re-audit schedule.  Before this
module each of those carried its own ad-hoc constant and a bare
``asyncio.sleep``; now the shape of every retry (base, cap, growth,
jitter, attempt budget) is declared in one place (``defaults.py``) and the
loops share the same three small mechanisms:

* :class:`Backoff` — stateful attempt counter with ``await sleep()`` for
  loops that block between attempts (dial retries, WS reconnect).
* :class:`RetryTimer` — wall-clock variant for polling loops that must
  not block (the send loop re-requests storage only when ``due(now)``).
* :func:`retry_async` — run-awaitable-until-it-sticks wrapper for the
  simple "try N times" call sites.

Jitter is *full-range multiplicative*: the delay is drawn uniformly from
``[d*(1-j), d*(1+j)]`` so a fleet of clients retrying against one server
decorrelates (the thundering-herd argument of Exponential Backoff And
Jitter, AWS Architecture Blog 2015).  Policies that feed persisted,
test-asserted schedules (the audit ledger) set ``jitter=0``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from .. import defaults
from . import clock as clockmod
from ..obs import journal as obs_journal
from ..obs import metrics as obs_metrics

_ATTEMPTS = obs_metrics.counter(
    "bkw_retry_attempts_total", "Retry/backoff firings by named policy",
    ("policy",))


def _record_attempt(policy: "RetryPolicy", attempt: int) -> None:
    label = policy.name or "anonymous"
    _ATTEMPTS.inc(policy=label)
    obs_journal.emit("retry", policy=label, attempt=attempt)


@dataclass(frozen=True)
class RetryPolicy:
    """Shape of one retry schedule; immutable so call sites can share it."""

    base_s: float
    cap_s: float
    multiplier: float = 2.0
    jitter: float = defaults.RETRY_JITTER  # +/- fraction of the raw delay
    max_attempts: Optional[int] = None  # retries allowed; None = unbounded
    name: str = ""  # metric/journal label; last so positional sites hold

    def delay_s(self, attempt: int,
                rand: Optional[Callable[[], float]] = None) -> float:
        """Delay before retry number ``attempt`` (1-based).

        ``rand`` is an injectable uniform-[0,1) source so tests (and the
        deterministic fault plane) can pin the jitter draw.
        """
        raw = min(self.base_s * self.multiplier ** max(0, attempt - 1),
                  self.cap_s)
        if self.jitter <= 0:
            return raw
        u = (rand or random.random)()
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * u)


class Backoff:
    """Stateful attempt counter over a policy, for blocking retry loops.

    ``reset()`` after a success so the next failure starts from the base
    delay again (a reconnect loop must not inherit the backoff of an
    outage it already survived).
    """

    def __init__(self, policy: RetryPolicy,
                 rand: Optional[Callable[[], float]] = None,
                 clock=None):
        self.policy = policy
        self._rand = rand
        self.clock = clockmod.resolve(clock)
        self.attempt = 0

    def reset(self) -> None:
        self.attempt = 0

    def next_delay(self) -> Optional[float]:
        """Delay for the next retry, or None when attempts are exhausted."""
        self.attempt += 1
        if self.policy.max_attempts is not None \
                and self.attempt > self.policy.max_attempts:
            return None
        _record_attempt(self.policy, self.attempt)
        return self.policy.delay_s(self.attempt, self._rand)

    async def sleep(self) -> bool:
        """Sleep for the next delay; False when the budget is exhausted."""
        delay = self.next_delay()
        if delay is None:
            return False
        await self.clock.sleep(delay)
        return True


class RetryTimer:
    """Wall-clock backoff for polling loops that must not block.

    The send loop polls its buffer every tick; the storage request inside
    it may only fire when the previous one's backoff window has elapsed.
    ``due(now)`` answers that, ``fire(now)`` marks an attempt and arms the
    next window, ``reset()`` clears the schedule after a success.  A fresh
    timer is due immediately.
    """

    def __init__(self, policy: RetryPolicy,
                 rand: Optional[Callable[[], float]] = None,
                 clock=None):
        self.policy = policy
        self._rand = rand
        self.clock = clockmod.resolve(clock)
        self.attempt = 0
        self._next_at = 0.0

    def due(self, now: Optional[float] = None) -> bool:
        now = self.clock.now() if now is None else now
        return now >= self._next_at

    def fire(self, now: Optional[float] = None) -> None:
        now = self.clock.now() if now is None else now
        self.attempt += 1
        _record_attempt(self.policy, self.attempt)
        self._next_at = now + self.policy.delay_s(self.attempt, self._rand)

    def reset(self) -> None:
        self.attempt = 0
        self._next_at = 0.0


async def retry_async(fn, policy: RetryPolicy, *,
                      retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                      rand: Optional[Callable[[], float]] = None,
                      on_retry: Optional[Callable] = None,
                      clock=None):
    """``await fn()`` with retries per ``policy``; re-raises the last error
    once the attempt budget is spent.  ``on_retry(attempt, exc)`` observes
    each failure (logging hook); ``clock`` routes the backoff sleeps
    through the clock seam (``utils.clock``) for virtual-time callers."""
    backoff = Backoff(policy, rand, clock=clock)
    while True:
        try:
            return await fn()
        except retry_on as e:
            if not await backoff.sleep():
                raise
            if on_retry is not None:
                on_retry(backoff.attempt, e)


# --- the client's shared policies (tunables live in defaults.py) ------------

#: p2p dial retries (handle_connections.rs:145-165 hardcoded 3 tries/0.5 s).
DIAL = RetryPolicy(base_s=defaults.DIAL_RETRY_BASE_S,
                   cap_s=defaults.DIAL_RETRY_CAP_S,
                   max_attempts=defaults.DIAL_RETRY_ATTEMPTS,
                   name="dial")

#: server push-channel reconnect (net_server/mod.rs:26-55 hardcoded 0.2 s).
WS_RECONNECT = RetryPolicy(base_s=defaults.WS_RECONNECT_BASE_S,
                           cap_s=defaults.WS_RECONNECT_CAP_S,
                           name="ws_reconnect")

#: storage-request re-issue while no peer has room (send.rs:296-309).
STORAGE_REQUEST = RetryPolicy(base_s=defaults.STORAGE_REQUEST_RETRY_S,
                              cap_s=defaults.STORAGE_REQUEST_RETRY_CAP_S,
                              name="storage_request")

#: send-loop pacing while waiting for the packer to produce.
SEND_IDLE = RetryPolicy(base_s=defaults.SEND_IDLE_BASE_S,
                        cap_s=defaults.SEND_IDLE_CAP_S,
                        name="send_idle")

#: send-loop pacing while waiting for a usable peer.
PEER_WAIT = RetryPolicy(base_s=defaults.PEER_WAIT_BASE_S,
                        cap_s=defaults.PEER_WAIT_CAP_S,
                        name="peer_wait")

#: audit ledger re-audit schedule after a miss/failure.  jitter=0: the
#: ledger persists absolute ``next_due`` times that tests (and operators
#: reading the ledger) must be able to predict exactly.
AUDIT = RetryPolicy(base_s=defaults.AUDIT_RETRY_BASE_S,
                    cap_s=defaults.AUDIT_BACKOFF_CAP_S,
                    jitter=0.0, name="audit")
