"""Bounded-concurrency transfer scheduler: the send plane's fan-out seam.

Counterpart of ``backuwup_tpu/net/transfer.py``, copied so that the port
imports nothing of the JAX package.

The reference transmits strictly one file at a time (``send.rs`` awaits
every ack inline); this module lets the engine keep many uploads in
flight at once — every missing shard of a stripe to its distinct peer,
and several whole packfiles to several connected peers — while keeping
the three invariants the serial code had for free (docs/transfer.md):

* **Per-peer ordering.**  One ``asyncio.Lock`` per peer serializes the
  actual sends to that peer, and submissions park on the lock in FIFO
  order, so a peer observes the same file sequence the serial loop would
  have produced.  This is load-bearing: a Transport assigns its signed
  sequence number synchronously inside ``send_data`` and the receiver
  rejects any reordering as a "sequence break", so two concurrent
  ``send_data`` calls on one transport would poison the session.
* **Bounded in-flight bytes.**  Admission waits until the payload fits
  under ``max_inflight_bytes`` (and ``max_transfers``); a transfer larger
  than the whole budget is still admitted when nothing else is in flight
  so oversize files cannot deadlock the plane.  The cap bounds the RAM
  the plane holds *in addition to* the Orchestrator's on-disk buffer
  accounting — payloads are read inside the submitted coroutine, after
  admission, so queued transfers hold no bytes.
* **Failure isolation.**  Each transfer's exception is captured in its
  ``TransferResult``; sibling transfers to other peers run to completion
  and the caller decides per-peer what to drop — exactly the blast
  radius a failed peer had under the serial loop.

Telemetry flows through ``messenger.transfer`` per completed transfer
(in-flight gauges, wait/send stage times) so the UI can watch the plane
breathe.  The fault plane (utils/faults.py) hooks the Transport layer
below this module and keeps working unchanged.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Dict, List, Optional

from .. import defaults
from ..obs import journal as obs_journal
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .p2p import P2PError, SendProgress

_WAIT_SECONDS = obs_metrics.histogram(
    "bkw_transfer_wait_seconds",
    "Seconds a transfer waits on per-peer ordering + byte admission")
_SEND_SECONDS = obs_metrics.histogram(
    "bkw_transfer_send_seconds",
    "Seconds spent in ws.send + ack per transfer")
_TRANSFERS = obs_metrics.counter(
    "bkw_transfers_total", "Completed transfers by outcome", ("outcome",))
_BYTES_SENT = obs_metrics.counter(
    "bkw_transfer_bytes_total", "Payload bytes successfully transferred")
#: resume-plane waste gauge: payload bytes shipped more than once because
#: a transfer was cut and continued (engine._send_resumable accounts the
#: overlap between attempts).  The wan scenario gates on this staying
#: under budget — resume means re-sending the tail, not the file.
BYTES_RESENT = obs_metrics.counter(
    "bkw_transfer_bytes_resent_total",
    "Payload bytes re-sent across resume attempts")
_INFLIGHT = obs_metrics.gauge(
    "bkw_transfer_inflight", "Transfers currently admitted")
_INFLIGHT_BYTES = obs_metrics.gauge(
    "bkw_transfer_inflight_bytes", "Payload bytes currently admitted")
# --- restore data plane (download lanes; docs/transfer.md) -------------------
RESTORE_BYTES_PULLED = obs_metrics.counter(
    "bkw_restore_bytes_pulled_total",
    "Payload bytes pulled through download lanes, by source peer",
    ("peer",))
RESTORE_HEDGES = obs_metrics.counter(
    "bkw_restore_hedges_total",
    "Hedged redundant pulls by outcome: won = the hedge's shard was used,"
    " lost = the stalled primary finished first anyway, wasted = neither"
    " pull delivered", ("outcome",))
RESTORE_SOURCES = obs_metrics.histogram(
    "bkw_restore_sources_per_stripe",
    "Distinct source peers a restored stripe's shards were pulled from",
    buckets=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0))


@dataclass
class TransferResult:
    """Outcome of one scheduled transfer (never raises past the plane)."""

    peer_id: bytes
    size: int
    ok: bool
    error: Optional[BaseException] = None
    label: str = ""
    wait_s: float = 0.0  # admission + per-peer ordering queue time
    send_s: float = 0.0  # time inside the send coroutine


class TransferScheduler:
    """Admission control + per-peer ordering for concurrent uploads.

    ``submit`` returns an ``asyncio.Task`` resolving to a
    ``TransferResult``; the task never raises (cancellation aside), so a
    ``gather`` over a batch cannot be torn down by one bad peer.
    """

    def __init__(self, max_inflight_bytes: Optional[int] = None,
                 max_transfers: Optional[int] = None, messenger=None,
                 peer_stats=None):
        self.max_inflight_bytes = int(
            defaults.TRANSFER_INFLIGHT_BYTE_CAP
            if max_inflight_bytes is None else max_inflight_bytes)
        self.max_transfers = int(
            defaults.TRANSFER_MAX_INFLIGHT
            if max_transfers is None else max_transfers)
        self.messenger = messenger
        self.peer_stats = peer_stats  # net/peer_stats.py estimator bank
        self.inflight_bytes = 0
        self.inflight_count = 0
        self.completed = 0
        self.failed = 0
        self.bytes_sent = 0
        self.bytes_pulled = 0
        self.stage_s = {"wait": 0.0, "send": 0.0}
        self._cond = asyncio.Condition()
        self._peer_locks: Dict[bytes, asyncio.Lock] = {}
        self._peer_pending: Dict[bytes, int] = {}

    def peer_busy(self, peer_id: bytes) -> bool:
        """True while any submitted transfer to ``peer_id`` is unresolved
        (parked behind the per-peer lock or actively sending).  Connection
        management consults this before closing a transport: dropping a
        socket with pending jobs strands their ack waits and forces an
        abort-and-resume redial for work that was proceeding fine."""
        return self._peer_pending.get(bytes(peer_id), 0) > 0

    # --- admission (the in-flight byte cap) --------------------------------

    async def _admit(self, size: int) -> None:
        async with self._cond:
            while self.inflight_count > 0 and (
                    self.inflight_count >= self.max_transfers
                    or self.inflight_bytes + size > self.max_inflight_bytes):
                await self._cond.wait()
            self.inflight_count += 1
            self.inflight_bytes += size
            _INFLIGHT.set(self.inflight_count)
            _INFLIGHT_BYTES.set(self.inflight_bytes)

    async def _release(self, size: int) -> None:
        async with self._cond:
            self.inflight_count -= 1
            self.inflight_bytes -= size
            _INFLIGHT.set(self.inflight_count)
            _INFLIGHT_BYTES.set(self.inflight_bytes)
            self._cond.notify_all()

    # --- submission --------------------------------------------------------

    def submit(self, peer_id: bytes, size: int,
               send: Callable[[], Awaitable[None]],
               label: str = "") -> "asyncio.Task[TransferResult]":
        """Schedule ``send()`` (which reads + transmits + does post-ack
        bookkeeping) as one bounded, peer-ordered transfer."""
        return asyncio.ensure_future(
            self._run(bytes(peer_id), int(size), send, label))

    def submit_pull(self, peer_id: bytes, size: int,
                    pull: Callable[[], Awaitable[Optional[int]]],
                    label: str = "") -> "asyncio.Task[TransferResult]":
        """Schedule ``pull()`` — a download from ``peer_id`` — on the same
        plane: same per-peer ordering (a pull and an upload to one peer
        must not interleave on one signed-sequence session), same byte
        admission (``size`` is the expected payload), same failure
        isolation.  ``pull()`` may return the actual byte count received;
        successful pulls feed the peer estimators as receive-direction
        samples and ``bkw_restore_bytes_pulled_total{peer}``."""
        return asyncio.ensure_future(
            self._run(bytes(peer_id), int(size), pull, label,
                      direction="pull"))

    async def _run(self, peer_id: bytes, size: int,
                   send: Callable[[], Awaitable[None]],
                   label: str, direction: str = "send") -> TransferResult:
        # pending-count bookkeeping wraps the whole job — including the
        # park behind the per-peer lock — so peer_busy() covers queued
        # work and survives cancellation mid-wait
        self._peer_pending[peer_id] = self._peer_pending.get(peer_id, 0) + 1
        try:
            return await self._run_locked(peer_id, size, send, label,
                                          direction)
        finally:
            n = self._peer_pending.get(peer_id, 1) - 1
            if n <= 0:
                self._peer_pending.pop(peer_id, None)
            else:
                self._peer_pending[peer_id] = n

    async def _run_locked(self, peer_id: bytes, size: int,
                          send: Callable[[], Awaitable[None]],
                          label: str, direction: str = "send"
                          ) -> TransferResult:
        t0 = time.monotonic()
        # Per-peer lock first: asyncio.Lock wakes waiters FIFO and tasks
        # run synchronously up to their first await, so same-peer
        # transfers send in submission order.  Admission happens inside
        # the lock so parked transfers hold no byte budget.
        lock = self._peer_locks.setdefault(peer_id, asyncio.Lock())
        async with lock:
            await self._admit(size)
            t1 = time.monotonic()
            try:
                # the span inherits the submitting backup's trace id (the
                # contextvar copied into this task at submit time) and is
                # what _sign_body stamps onto the envelope
                with obs_trace.span("transfer." + direction):
                    out = await send()
                result = TransferResult(peer_id, size, True, label=label)
                if isinstance(out, int) and out >= 0:
                    # downloads report actual bytes received; the
                    # estimators should learn the real rate, not the plan
                    result.size = out
            except (Exception, asyncio.TimeoutError) as e:
                result = TransferResult(peer_id, size, False, error=e,
                                        label=label)
            finally:
                t2 = time.monotonic()
                await self._release(size)
        result.wait_s = t1 - t0
        result.send_s = t2 - t1
        self.stage_s["wait"] += result.wait_s
        self.stage_s["send"] += result.send_s
        _WAIT_SECONDS.observe(result.wait_s)
        _SEND_SECONDS.observe(result.send_s)
        ok_word = "sent" if direction == "send" else "pulled"
        _TRANSFERS.inc(outcome=ok_word if result.ok else "failed")
        if result.ok:
            self.completed += 1
            if direction == "send":
                self.bytes_sent += size
                _BYTES_SENT.inc(size)
            else:
                self.bytes_pulled += result.size
                RESTORE_BYTES_PULLED.inc(result.size,
                                         peer=peer_id.hex()[:16])
        else:
            self.failed += 1
        if self.peer_stats is not None:
            try:
                self.peer_stats.observe(result)
            except Exception:
                pass  # estimators are hints; never fail a transfer
        if self.messenger is not None:
            self.messenger.transfer(
                peer_id.hex()[:16], ok_word if result.ok else "failed",
                size=size, inflight=self.inflight_count,
                inflight_bytes=self.inflight_bytes,
                wait_ms=result.wait_s * 1000.0,
                send_ms=result.send_s * 1000.0, label=label)
        return result

    # --- shared resume loop (upload, restore and repair all ride it) --------

    @staticmethod
    async def run_resumable(transport, peer_id: bytes, data: bytes,
                            file_info, file_id: bytes, *,
                            throughput_bps: float = 0.0,
                            redial: Optional[Callable] = None,
                            on_drop: Optional[Callable] = None,
                            resume: Optional[bool] = None,
                            attempts: Optional[int] = None) -> None:
        """``send_file`` with the abort-and-resume loop around it
        (formerly ``Engine._send_resumable`` — it lives in the scheduler
        now so every send path shares one loop).

        A mid-transfer failure (cut link, stalled ack) drops the poisoned
        transport via ``on_drop``, reconnects via ``redial`` (an async
        callable returning a fresh started Transport — the caller owns
        connection bookkeeping), and continues the chunked send from the
        receiver's verified offset, up to ``attempts`` reconnects before
        the failure surfaces.  Bytes shipped more than once across
        attempts are accounted to ``bkw_transfer_bytes_resent_total``
        (the wan scenario's budget)."""
        peer_id = bytes(peer_id)
        if resume is None:
            resume = bool(defaults.TRANSFER_RESUME_ENABLED)
        if attempts is None:
            attempts = int(defaults.TRANSFER_RESUME_ATTEMPTS)
        hwm = 0  # high-water wire offset across attempts
        t = transport
        for attempt in range(attempts + 1):
            prog = SendProgress()
            try:
                await t.send_file(data, file_info, file_id, resume=resume,
                                  throughput_bps=throughput_bps,
                                  progress=prog)
                BYTES_RESENT.inc(max(0, min(prog.offset, hwm)
                                     - prog.started))
                return
            except P2PError as e:
                # the overlap between this attempt's shipped range and
                # anything shipped before is waste the resume plane
                # failed to avoid
                BYTES_RESENT.inc(max(0, min(prog.offset, hwm)
                                     - prog.started))
                hwm = max(hwm, prog.offset)
                if on_drop is not None:
                    await on_drop()
                if attempt >= attempts or redial is None:
                    raise
                obs_journal.emit("transfer_resume",
                                 peer=peer_id.hex()[:16],
                                 attempt=attempt + 1,
                                 offset=prog.offset, error=str(e))
                t = await redial()

    # --- download lanes: re-queue + hedging ---------------------------------

    async def pull_with_requeue(self, sources: List[bytes], size: int,
                                make_pull: Callable, label: str = ""
                                ) -> Optional[TransferResult]:
        """One logical download over a ranked candidate list: run
        ``make_pull(peer)()`` on the best source; when it fails or stalls
        out, re-queue the same work behind the next-healthiest candidate
        instead of hammering the peer that just failed.  Returns the first
        successful result, the last failure when every candidate failed,
        or None when ``sources`` is empty."""
        last: Optional[TransferResult] = None
        for peer in list(sources):
            res = await self.submit_pull(peer, size, make_pull(peer),
                                         label=label)
            if res.ok:
                return res
            last = res
            obs_journal.emit("restore_requeue",
                             peer=bytes(peer).hex()[:16], label=label,
                             error=str(res.error))
        return last

    async def pull_hedged(self, primary: "asyncio.Task[TransferResult]",
                          spawn_hedge: Callable, hedge_after_s: float
                          ) -> Optional[TransferResult]:
        """Race a lagging download against a redundant one.

        ``primary`` is an already-submitted pull task.  If it neither
        completes nor fails within ``hedge_after_s``, ``spawn_hedge()`` is
        invoked to launch a redundant pull (of an equivalent spare shard,
        from a different holder; it may return None when no spare is
        available) and the two race — the first success wins and the
        loser is cancelled, so a stalled holder costs the hedge delay,
        never the full deadline.  Outcomes land in
        ``bkw_restore_hedges_total``: won (the hedge delivered), lost
        (the primary recovered first anyway), wasted (both failed)."""
        try:
            return await asyncio.wait_for(asyncio.shield(primary),
                                          hedge_after_s)
        except asyncio.TimeoutError:
            pass  # primary is lagging: hedge it
        except asyncio.CancelledError:
            raise
        hedge = spawn_hedge()
        if hedge is None:
            try:
                return await primary
            except asyncio.CancelledError:
                return None
        done, pending = await asyncio.wait(
            {primary, hedge}, return_when=asyncio.FIRST_COMPLETED)

        def _result(task):
            try:
                return task.result()
            except asyncio.CancelledError:
                return None

        first_ok = None
        for task in done:
            r = _result(task)
            if r is not None and r.ok:
                # prefer the primary when both landed in the same tick:
                # its bytes were already counted and the hedge was waste
                if first_ok is None or task is primary:
                    first_ok = (task, r)
        if first_ok is not None:
            for task in pending:
                task.cancel()
            outcome = "lost" if first_ok[0] is primary else "won"
            RESTORE_HEDGES.inc(outcome=outcome)
            return first_ok[1]
        # the first finisher failed; the race is decided by the survivor
        survivor = next(iter(pending), None)
        sr = None
        if survivor is not None:
            try:
                sr = await survivor
            except asyncio.CancelledError:
                sr = None
        if sr is not None and sr.ok:
            RESTORE_HEDGES.inc(
                outcome="won" if survivor is hedge else "lost")
            return sr
        RESTORE_HEDGES.inc(outcome="wasted")
        for task in done:
            r = _result(task)
            if r is not None:
                return r
        return sr

    @staticmethod
    async def gather(tasks: List["asyncio.Task[TransferResult]"]
                     ) -> List[TransferResult]:
        """Await a batch; results arrive in submission order and no
        exception escapes (each task resolves to a TransferResult)."""
        if not tasks:
            return []
        return list(await asyncio.gather(*tasks))

    @staticmethod
    async def as_completed(tasks: List["asyncio.Task[TransferResult]"]):
        """Yield each ``TransferResult`` the moment its transfer
        resolves (completion order, not submission order) — the reap
        side of continuous admission (docs/dataflow.md): the caller
        reacts to a failed peer while its siblings are still on the
        wire instead of after the whole batch gathers."""
        pending = set(tasks)
        while pending:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                yield t.result()
