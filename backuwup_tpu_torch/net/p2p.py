"""P2P data plane: signed, replay-protected, acked peer-to-peer transfer.

Counterpart of ``backuwup_tpu/net/p2p.py``, copied so that the port
imports nothing of the JAX package. Its frames, signatures and stored
bytes are the reference's, so a node of either package talks to the other.

Re-designs ``client/src/net_p2p/``: all backup bytes move client<->client
over WebSocket, end-to-end authenticated:

* Every message is an :class:`~backuwup_tpu_torch.wire.EncapsulatedMsg` — an
  Ed25519-signed :class:`~backuwup_tpu_torch.wire.P2PBody` carrying a replay
  header (random 16-byte session nonce + strictly-sequential sequence
  number, ``p2p_message.rs:21-24``, ``receive.rs:95-105``).
* Connections rendezvous through the coordination server: the initiator
  registers a nonce (60 s expiry, ``p2p_connection_manager.rs``), the
  acceptor binds a random port and confirms its address, the initiator
  dials and sends the signed seq-0 request (``handle_connections.rs``).
* Per-file acks with timeouts (``transport.rs:127-128``); packfiles are
  deleted by the sender only after the ack (``send.rs:277-289``).
* Hosts store received packfiles XOR-obfuscated with a local 4-byte key so
  a casual host can't read foreign (already encrypted) packfiles
  (``received_files_writer.rs:76-78``); quota = negotiated − received with
  a 16 MiB grace (``:101-108``).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

try:
    import websockets
except ModuleNotFoundError:  # containers without the wheel: aiohttp shim
    from ..utils import ws_compat as websockets

from .. import defaults, wire
from ..crypto import KeyManager, verify_signature
from ..obs import journal as obs_journal
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..ops.blake3_cpu import blake3_many
from ..store import Store
from ..utils import durable, faults, retry

_P2P_BYTES = obs_metrics.counter(
    "bkw_p2p_bytes_sent_total",
    "Signed frame bytes shipped through the transport send chokepoint")
_SEQ_BREAKS = obs_metrics.counter(
    "bkw_p2p_sequence_breaks_total",
    "Receiver sequence-validation failures (replay protection tripped)")
_PARTS = obs_metrics.counter(
    "bkw_transfer_parts_total", "FILE_PART frames acked end-to-end")
_RESUMES = obs_metrics.counter(
    "bkw_transfer_resumes_total",
    "RESUME_OFFER outcomes on chunked sends (resumed / restarted_*)",
    ("outcome",))
_STALLS = obs_metrics.counter(
    "bkw_transfer_stalls_total",
    "Adaptive-deadline expiries (transfer aborted toward resume)")
_PARTIALS_EXPIRED = obs_metrics.counter(
    "bkw_partials_expired_total",
    "Abandoned partial transfers expired by the receiver-side TTL janitor")
_RECLAIM_REQUESTS = obs_metrics.counter(
    "bkw_reclaim_requests_total",
    "RECLAIM requests served (holder side), by outcome", ("outcome",))
_RECLAIM_BYTES_FREED = obs_metrics.counter(
    "bkw_reclaim_bytes_freed_total",
    "Bytes a holder deleted (and credited back) while serving RECLAIMs")

# Crash-matrix seam around the receiver's partial-stage commit
_CP_PARTIAL_PRE = faults.register_crash_site("partial.sink.pre")
_CP_PARTIAL_POST = faults.register_crash_site("partial.sink.post")

PURPOSE_TRANSPORT = wire.RequestType.TRANSPORT
PURPOSE_RESTORE = wire.RequestType.RESTORE_ALL
PURPOSE_AUDIT = wire.RequestType.AUDIT


class P2PError(Exception):
    pass


def obfuscate(data: bytes, key: bytes) -> bytes:
    """XOR with a repeating 4-byte key (net_p2p/mod.rs:38-47); involutive."""
    if len(key) != 4:
        raise ValueError("obfuscation key must be 4 bytes")
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    pad = -len(arr) % 4
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, np.uint8)])
    k = np.frombuffer(bytes(key) * (len(arr) // 4), dtype=np.uint8)
    out = (arr ^ k).tobytes()
    return out[:len(data)]


def adaptive_deadline(size: int, throughput_bps: float = 0.0) -> float:
    """Per-transfer ack deadline scaled to payload size (docs/transfer.md).

    Replaces the fixed ``ACK_TIMEOUT_S`` for sized payloads: the budget is
    the ack floor plus the seconds the payload needs at the slower of the
    assumed minimum link rate and the peer's measured EWMA throughput
    derated by the safety fraction — so a large file on a slow-but-alive
    link is not declared dead, while a genuine stall still trips fast.
    """
    floor = float(defaults.TRANSFER_MIN_THROUGHPUT_BPS)
    if throughput_bps > 0.0:
        floor = max(floor, throughput_bps * defaults.TRANSFER_DEADLINE_SAFETY)
    return min(defaults.ACK_TIMEOUT_S + size / max(floor, 1.0),
               defaults.TRANSFER_DEADLINE_CAP_S)


class SendProgress:
    """Wire-progress of one ``send_file`` attempt, for resume accounting:
    ``started`` is the offset the attempt resumed from, ``offset`` the
    high-water byte that has hit the wire (updated before each part's ack,
    so a cut mid-ack still counts its shipped bytes)."""

    def __init__(self) -> None:
        self.started = 0
        self.offset = 0


def validate_resume_offer(offer: wire.P2PBody, data: bytes, digest: bytes,
                          file_id: bytes) -> Tuple[int, str]:
    """Decide where a chunked send restarts given the receiver's offer.

    Returns ``(start_offset, outcome)``.  A verified prefix resumes
    (``resumed``); a digest mismatch means the receiver holds a partial of
    a *different* file version (``restarted_stale``) and a bad prefix
    digest means its partial is corrupt (``restarted_corrupt``) — both
    restart from zero, and the receiver discards its partial when part 0
    arrives.  Never trusts the offer: the whole-file digest is recomputed
    sender-side and the final assembled file is verified receiver-side.
    """
    if offer.kind != wire.P2PBodyKind.RESUME_OFFER:
        raise P2PError("expected a RESUME_OFFER body")
    if bytes(offer.file_id) != bytes(file_id):
        raise P2PError("RESUME_OFFER for a different file id")
    off = int(offer.offset)
    if off <= 0 or off > len(data):
        return 0, "cold"
    if bytes(offer.file_digest) != bytes(digest):
        return 0, "restarted_stale"
    if bytes(offer.prefix_digest) != blake3_many([data[:off]])[0]:
        return 0, "restarted_corrupt"
    return off, "resumed"


class ConnectionRequests:
    """Outgoing-request registry: anti-unsolicited-connection bookkeeping
    with expiry (p2p_connection_manager.rs:17-66)."""

    def __init__(self, ttl_s: float = defaults.P2P_REQUEST_TTL_S):
        self.ttl_s = ttl_s
        self._pending: Dict[bytes, tuple] = {}  # peer -> (nonce, purpose, exp)

    def add(self, peer_id: bytes, purpose: wire.RequestType) -> bytes:
        nonce = os.urandom(wire.TRANSPORT_NONCE_LEN)
        self._pending[bytes(peer_id)] = (nonce, purpose,
                                         time.time() + self.ttl_s)
        return nonce

    def finalize(self, peer_id: bytes) -> tuple:
        entry = self._pending.pop(bytes(peer_id), None)
        if entry is None or entry[2] < time.time():
            raise P2PError("no pending connection request for peer")
        return entry[0], entry[1]


def _sign_body(keys: KeyManager, body: wire.P2PBody) -> bytes:
    encoded = body.encode_bytes()
    # the caller's trace id rides outside the signed body (advisory
    # correlation metadata — see wire.EncapsulatedMsg)
    return wire.EncapsulatedMsg(
        body=encoded, signature=keys.sign(encoded),
        trace_id=obs_trace.current_trace_id()).encode_bytes()


def _verify_msg(raw: bytes, peer_id: bytes) -> wire.P2PBody:
    if len(raw) > defaults.MAX_P2P_MESSAGE_SIZE:
        raise P2PError("p2p message exceeds size cap")
    msg = wire.EncapsulatedMsg.decode_bytes(raw)
    if not verify_signature(peer_id, msg.body, msg.signature):
        raise P2PError("bad message signature")
    body = wire.P2PBody.decode_bytes(msg.body)
    # ride the sender's trace id alongside the body (frozen dataclass:
    # a side-channel attribute, never part of equality or encoding)
    object.__setattr__(body, "trace_id",
                       obs_trace.clean_trace_id(msg.trace_id))
    return body


class Transport:
    """Send side: ordered, signed, acked file transfer (transport.rs)."""

    def __init__(self, ws, keys: KeyManager, peer_id: bytes,
                 session_nonce: bytes, first_seq: int = 1):
        self.ws = ws
        self.keys = keys
        self.peer_id = bytes(peer_id)
        self.session_nonce = bytes(session_nonce)
        self.seq = first_seq
        self._acks: Dict[int, asyncio.Event] = {}
        self._listen_done = False
        self._ack_task: Optional[asyncio.Task] = None
        self._recv_queue: asyncio.Queue = asyncio.Queue()

    def start(self) -> None:
        if self._ack_task is None:
            self._ack_task = asyncio.create_task(self._listen())

    async def _listen(self) -> None:
        """Verify + route incoming frames: acks release waiting senders,
        data frames queue for the receive loop (duplex socket)."""
        try:
            async for raw in self.ws:
                try:
                    body = _verify_msg(raw, self.peer_id)
                except P2PError:
                    continue
                if body.header.session_nonce != self.session_nonce:
                    continue
                if body.kind == wire.P2PBodyKind.ACK:
                    ev = self._acks.pop(body.acked_sequence, None)
                    if ev is not None:
                        ev.set()
                else:
                    await self._recv_queue.put(body)
        except websockets.ConnectionClosed:
            pass
        finally:
            # Wake every pending ack waiter: once this loop exits no ack
            # can ever arrive, and a silent exit would strand concurrent
            # senders for their full adaptive deadline (they'd count a
            # stall for what is really a closed transport — e.g. a
            # sibling admission tick dropping a peer it judged full).
            # _listen_done distinguishes this sweep from a real ack:
            # the waiter raises P2PError immediately into the
            # abort-and-resume path instead of counting a stall.
            self._listen_done = True
            for ev in self._acks.values():
                ev.set()
            # put_nowait (queue is unbounded): the await form would fail
            # with "Event loop is closed" when the task is GC'd at
            # interpreter/loop teardown
            try:
                self._recv_queue.put_nowait(None)
            except RuntimeError:
                pass

    async def _ship(self, raw: bytes, seq: Optional[int] = None,
                    timeout: Optional[float] = None) -> None:
        """The single outbound chokepoint: EVERY signed frame leaves
        through here, so the fault plane's drop/corrupt/latency sites see
        control frames (audit, resume negotiation) exactly as they see
        FILE frames — no chaos-immune traffic."""
        plane = faults.PLANE
        if plane is not None:  # chaos hook; inert in production (PLANE=None)
            action = await plane.on_send(self.peer_id)
            if action == faults.ACT_DROP:
                await self.close()
                if seq is not None:
                    self._acks.pop(seq, None)
                raise P2PError("injected connection drop"
                               + (f" at seq {seq}" if seq is not None else ""))
            if action == faults.ACT_CORRUPT:
                raw = plane.corrupt(raw, self.peer_id)
        _P2P_BYTES.inc(len(raw))
        try:
            await asyncio.wait_for(
                self.ws.send(raw),
                defaults.PACKFILE_SEND_TIMEOUT_S if timeout is None
                else timeout)
        except (asyncio.TimeoutError, websockets.ConnectionClosed) as e:
            raise P2PError(f"send failed: {e}") from e

    async def _send_acked(self, body: wire.P2PBody, seq: int,
                          deadline: float) -> None:
        """Ship one seq-carrying frame and wait for its signed ack under
        the adaptive deadline; a deadline expiry is counted as a stall
        (the caller aborts-and-resumes rather than restarting)."""
        ev = asyncio.Event()
        self._acks[seq] = ev
        raw = _sign_body(self.keys, body)
        try:
            await self._ship(raw, seq=seq,
                             timeout=max(defaults.PACKFILE_SEND_TIMEOUT_S,
                                         deadline))
            try:
                await asyncio.wait_for(ev.wait(), deadline)
            except asyncio.TimeoutError as e:
                _STALLS.inc()
                raise P2PError(
                    f"ack stalled for seq {seq}"
                    f" after {deadline:.1f}s") from e
            if self._listen_done and seq in self._acks:
                # woken by _listen's close-time sweep, not by an ack
                # (a real ack pops the seq before setting the event):
                # fail fast (no stall count — the link is gone, not slow)
                # so run_resumable can redial and resume immediately
                raise P2PError(
                    f"transport closed while awaiting ack for seq {seq}")
        finally:
            self._acks.pop(seq, None)

    async def send_data(self, data: bytes, file_info: wire.FileInfoKind,
                        file_id: bytes, throughput_bps: float = 0.0) -> None:
        """Send one file as a single FILE frame; waits for the signed ack
        (transport.rs:111-132).  The ack deadline scales with payload size
        so a large file on a slow link is distinguishable from a dead
        peer even on this legacy non-chunked path."""
        seq = self.seq
        self.seq += 1
        body = wire.P2PBody(
            kind=wire.P2PBodyKind.FILE,
            header=wire.P2PHeader(sequence_number=seq,
                                  session_nonce=self.session_nonce),
            file_info=file_info, file_id=bytes(file_id), data=bytes(data))
        await self._send_acked(
            body, seq, adaptive_deadline(len(data), throughput_bps))

    async def send_file(self, data: bytes, file_info: wire.FileInfoKind,
                        file_id: bytes, *, resume: bool = True,
                        throughput_bps: float = 0.0,
                        progress: Optional[SendProgress] = None) -> None:
        """Send one file, chunked into resumable FILE_PART frames when it
        exceeds ``TRANSFER_CHUNK_BYTES`` (else the legacy FILE frame).

        A chunked send first asks the receiver how much of ``file_id`` it
        already holds (RESUME_QUERY/RESUME_OFFER) and continues from the
        verified offset; the receiver checks the assembled file against
        the whole-file digest before the final part's ack.
        """
        data = bytes(data)
        chunk = int(defaults.TRANSFER_CHUNK_BYTES)
        if chunk <= 0 or len(data) <= chunk:
            if progress is not None:
                progress.offset = len(data)  # all-or-nothing frame
            await self.send_data(data, file_info, file_id,
                                 throughput_bps=throughput_bps)
            return
        loop = asyncio.get_running_loop()
        digest = await loop.run_in_executor(
            None, lambda: blake3_many([data])[0])
        start = 0
        if resume:
            start = await self._negotiate_resume(data, file_info, file_id,
                                                 digest, throughput_bps)
        if progress is not None:
            progress.started = start
            progress.offset = start
        off = start
        while off < len(data):
            part = data[off:off + chunk]
            plane = faults.PLANE
            if plane is not None:
                if plane.on_send_part(self.peer_id, off,
                                      len(part)) == faults.ACT_DROP:
                    await self.close()
                    raise P2PError(
                        f"injected mid-transfer cut at offset {off}")
            seq = self.seq
            self.seq += 1
            body = wire.P2PBody(
                kind=wire.P2PBodyKind.FILE_PART,
                header=wire.P2PHeader(sequence_number=seq,
                                      session_nonce=self.session_nonce),
                file_info=file_info, file_id=bytes(file_id), data=part,
                offset=off, total_size=len(data), file_digest=digest)
            if progress is not None:
                progress.offset = off + len(part)  # on the wire before ack
            await self._send_acked(
                body, seq, adaptive_deadline(len(part), throughput_bps))
            _PARTS.inc()
            off += len(part)

    async def _negotiate_resume(self, data: bytes,
                                file_info: wire.FileInfoKind,
                                file_id: bytes, digest: bytes,
                                throughput_bps: float) -> int:
        """RESUME_QUERY -> RESUME_OFFER round trip; returns the verified
        offset to continue from (0 = cold or restart)."""
        seq = self.seq
        self.seq += 1
        query = wire.P2PBody(
            kind=wire.P2PBodyKind.RESUME_QUERY,
            header=wire.P2PHeader(sequence_number=seq,
                                  session_nonce=self.session_nonce),
            file_info=file_info, file_id=bytes(file_id))
        await self._ship(_sign_body(self.keys, query))
        offer = await self.recv_body(adaptive_deadline(0, throughput_bps))
        loop = asyncio.get_running_loop()
        start, outcome = await loop.run_in_executor(
            None, lambda: validate_resume_offer(offer, data, digest,
                                                file_id))
        if int(offer.offset) > 0:
            _RESUMES.inc(outcome=outcome)
            obs_journal.emit("transfer_resume_offer",
                             peer=self.peer_id.hex()[:16], outcome=outcome,
                             offered=int(offer.offset), start=start)
        return start

    async def send_body(self, body: wire.P2PBody) -> None:
        """Fire one signed non-FILE body (audit challenge/proof exchange,
        resume offers — correlation is by echoed sequence number, not
        per-frame acks).  Routed through the fault chokepoint like every
        other outbound frame."""
        await self._ship(_sign_body(self.keys, body))

    async def recv_body(self, timeout: float) -> wire.P2PBody:
        """Next verified non-ACK body from the peer (None sentinel on close
        becomes an error: callers always expect a concrete body)."""
        try:
            body = await asyncio.wait_for(self._recv_queue.get(), timeout)
        except asyncio.TimeoutError as e:
            raise P2PError("timed out waiting for peer body") from e
        if body is None:
            raise P2PError("connection closed while waiting for peer body")
        return body

    async def close(self) -> None:
        if self._ack_task is not None:
            self._ack_task.cancel()
        try:
            await self.ws.close()
        except Exception:
            pass


class Receiver:
    """Receive side: strict-sequence validation + signed acks (receive.rs).

    ``sink(file_info, file_id, data)`` persists one whole file;
    ``part_sink(file_info, file_id, data, offset, total, digest)`` stages
    one FILE_PART (returning True when the file completed) and
    ``resume_query(file_info, file_id)`` answers RESUME_QUERY with
    ``(offset, digest, prefix_digest)`` — both default to None for legacy
    callers, which then reject chunked traffic.  The loop ends when the
    peer closes the socket.
    """

    def __init__(self, transport: Transport, sink: Callable,
                 first_seq: int = 1, part_sink: Optional[Callable] = None,
                 resume_query: Optional[Callable] = None):
        self.t = transport
        self.sink = sink
        self.part_sink = part_sink
        self.resume_query = resume_query
        self.expected_seq = first_seq

    async def run(self) -> int:
        """Returns the number of files received (completed, not parts)."""
        count = 0
        while True:
            body = await self.t._recv_queue.get()
            if body is None:
                return count
            if body.kind not in (wire.P2PBodyKind.FILE,
                                 wire.P2PBodyKind.FILE_PART,
                                 wire.P2PBodyKind.RESUME_QUERY):
                continue
            if body.header.sequence_number != self.expected_seq:
                # replay protection tripped: surface it (counter +
                # journal) and close the transport cleanly before
                # erroring out of the serve loop — a poisoned session
                # must not linger half-open
                _SEQ_BREAKS.inc()
                obs_journal.emit(
                    "p2p_sequence_break",
                    peer=self.t.peer_id.hex()[:16],
                    got=int(body.header.sequence_number),
                    expected=int(self.expected_seq))
                await self.t.close()
                raise P2PError(
                    f"sequence break: got {body.header.sequence_number}, "
                    f"expected {self.expected_seq} (replay protection)")
            if body.kind == wire.P2PBodyKind.RESUME_QUERY:
                await self._answer_resume_query(body)
                self.expected_seq += 1
                continue
            # adopt the sender's trace id so this store joins its pack/
            # transfer spans in the journal (the acceptance chain)
            with obs_trace.bind(getattr(body, "trace_id", None)), \
                    obs_trace.span("receiver.store"):
                if body.kind == wire.P2PBodyKind.FILE_PART:
                    if self.part_sink is None:
                        raise P2PError(
                            "peer sent FILE_PART but this receiver does"
                            " not support chunked transfer")
                    completed = await self.part_sink(
                        body.file_info, body.file_id, body.data,
                        body.offset, body.total_size, body.file_digest)
                else:
                    await self.sink(body.file_info, body.file_id, body.data)
                    completed = True
            plane = faults.PLANE
            if plane is not None \
                    and plane.withhold_ack_now(self.t.peer_id):
                # injected crash-between-write-and-ack: the file is
                # persisted but the sender never learns; do NOT advance
                # expected_seq — a real crash would lose that state too
                continue
            ack = wire.P2PBody(
                kind=wire.P2PBodyKind.ACK,
                header=wire.P2PHeader(sequence_number=self.expected_seq,
                                      session_nonce=self.t.session_nonce),
                acked_sequence=self.expected_seq)
            await self.t.ws.send(_sign_body(self.t.keys, ack))
            self.expected_seq += 1
            if completed:
                count += 1

    async def _answer_resume_query(self, body: wire.P2PBody) -> None:
        """RESUME_OFFER echoing the query's sequence number (the PROOF
        pattern: correlation by echoed seq, no ack)."""
        offset, digest, prefix = 0, b"", b""
        if self.resume_query is not None:
            offset, digest, prefix = await self.resume_query(
                body.file_info, body.file_id)
        reply = wire.P2PBody(
            kind=wire.P2PBodyKind.RESUME_OFFER,
            header=wire.P2PHeader(
                sequence_number=body.header.sequence_number,
                session_nonce=self.t.session_nonce),
            file_id=bytes(body.file_id), offset=int(offset),
            file_digest=bytes(digest), prefix_digest=bytes(prefix))
        await self.t.send_body(reply)


class PartialStore:
    """Receiver-side staging for chunked transfers (docs/transfer.md).

    One in-flight file is a ``<file_id hex>.bin`` byte prefix plus a
    ``.json`` meta record (total size, whole-file digest, file kind)
    under the writer's ``partial/`` subtree.  All methods are synchronous
    disk work — callers run them in an executor.  Invariants:

    * parts append strictly contiguously; a gap is a protocol error;
    * part 0 always truncates: a sender that restarted from zero (stale
      or corrupt partial) implicitly discards the old bytes;
    * the assembled file must match the whole-file BLAKE3 before it is
      handed to the real sink — a corrupted partial is discarded, never
      acked, never resumed.
    """

    def __init__(self, base: Path):
        self.base = Path(base)

    def _paths(self, file_id: bytes) -> Tuple[Path, Path]:
        stem = bytes(file_id).hex()
        return self.base / f"{stem}.bin", self.base / f"{stem}.json"

    def query(self, file_id: bytes) -> Tuple[int, bytes, bytes]:
        """(held bytes, whole-file digest, prefix digest) for RESUME_OFFER;
        (0, b"", b"") when nothing usable is held."""
        bin_p, meta_p = self._paths(file_id)
        if not bin_p.exists() or not meta_p.exists():
            return 0, b"", b""
        try:
            meta = json.loads(meta_p.read_text())
            digest = bytes.fromhex(meta["digest"])
            held = bin_p.read_bytes()
        except (KeyError, ValueError, OSError):
            self.discard(file_id)
            return 0, b"", b""
        if not held:
            return 0, b"", b""
        return len(held), digest, blake3_many([held])[0]

    def append(self, file_info: wire.FileInfoKind, file_id: bytes,
               offset: int, total: int, digest: bytes,
               data: bytes) -> Optional[bytes]:
        """Stage one part; returns the assembled, digest-verified bytes
        when the file completed, else None."""
        bin_p, meta_p = self._paths(file_id)
        offset, total = int(offset), int(total)
        if offset == 0:
            self.base.mkdir(parents=True, exist_ok=True)
            # tmp+replace+fsync: a crash mid-meta-write must never leave a
            # truncated .json that query() would half-trust on resume
            durable.write_replace(meta_p, json.dumps(
                {"total": total, "digest": bytes(digest).hex(),
                 "file_info": int(file_info)}, sort_keys=True).encode())
            bin_p.write_bytes(bytes(data))
        else:
            if not bin_p.exists() or not meta_p.exists():
                raise P2PError("FILE_PART continues an unknown partial")
            meta = json.loads(meta_p.read_text())
            if meta.get("digest") != bytes(digest).hex() \
                    or int(meta.get("total", -1)) != total:
                self.discard(file_id)
                raise P2PError("FILE_PART metadata mismatch;"
                               " partial discarded")
            held = bin_p.stat().st_size
            if offset != held:
                raise P2PError(f"non-contiguous FILE_PART: offset {offset},"
                               f" held {held}")
            with bin_p.open("ab") as f:
                f.write(bytes(data))
        held = bin_p.stat().st_size
        if held < total:
            return None
        raw = bin_p.read_bytes()
        if held > total or blake3_many([raw])[0] != bytes(digest):
            self.discard(file_id)
            raise P2PError("assembled file digest mismatch;"
                           " partial discarded")
        self.discard(file_id)
        return raw

    def discard(self, file_id: bytes) -> None:
        for p in self._paths(file_id):
            try:
                p.unlink()
            except OSError:
                pass

    def expire(self, ttl_s: Optional[float] = None,
               now: Optional[float] = None) -> int:
        """TTL janitor: delete abandoned partials (bin/json pairs — and
        stray meta ``.tmp`` files from a crashed writer) whose newest
        member is older than ``ttl_s``.  Returns the number of partial
        *files* (distinct ids) expired; each bumps
        ``bkw_partials_expired_total``.  A sender that never returns must
        not leak receiver quota forever."""
        ttl = defaults.PARTIAL_STORE_TTL_S if ttl_s is None else float(ttl_s)
        now = time.time() if now is None else float(now)
        if not self.base.is_dir():
            return 0
        newest: Dict[str, float] = {}
        members: Dict[str, list] = {}
        for p in self.base.iterdir():
            if not p.is_file():
                continue
            stem = p.name.split(".", 1)[0]
            try:
                mtime = p.stat().st_mtime
            except OSError:
                continue
            newest[stem] = max(newest.get(stem, 0.0), mtime)
            members.setdefault(stem, []).append(p)
        expired = 0
        for stem, latest in newest.items():
            if now - latest <= ttl:
                continue
            for p in members[stem]:
                try:
                    p.unlink()
                except OSError:
                    pass
            expired += 1
        if expired:
            _PARTIALS_EXPIRED.inc(expired)
        return expired


class _ResumableSinkMixin:
    """Chunked-transfer entry points riding on a writer's ``partials``
    (a :class:`PartialStore`) and whole-file ``sink``; wired into
    :class:`Receiver` as ``part_sink``/``resume_query``."""

    def _check_part_admission(self, file_info: wire.FileInfoKind,
                              file_id: bytes, total: int) -> None:
        """Veto hook before part 0 burns disk (quota, etc.)."""

    async def sink_part(self, file_info: wire.FileInfoKind, file_id: bytes,
                        data: bytes, offset: int, total: int,
                        digest: bytes) -> bool:
        loop = asyncio.get_running_loop()

        def stage():
            if int(offset) == 0:
                self._check_part_admission(file_info, file_id, int(total))
            faults.crashpoint(_CP_PARTIAL_PRE)
            out = self.partials.append(file_info, file_id, offset, total,
                                       digest, data)
            faults.crashpoint(_CP_PARTIAL_POST)
            return out

        raw = await loop.run_in_executor(None, stage)
        if raw is None:
            return False
        await self.sink(file_info, file_id, raw)
        return True

    async def resume_offer(self, file_info: wire.FileInfoKind,
                           file_id: bytes) -> Tuple[int, bytes, bytes]:
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.partials.query(file_id))


class ReceivedFilesWriter(_ResumableSinkMixin):
    """Store a peer's packfiles/indexes, obfuscated + quota-enforced
    (received_files_writer.rs)."""

    def __init__(self, store: Store, peer_id: bytes):
        self.store = store
        self.peer_id = bytes(peer_id)
        self.dir = store.received_dir(peer_id)
        self.partials = PartialStore(self.dir / "partial")
        key = store.get_obfuscation_key()
        if key is None:
            raise P2PError("obfuscation key not initialized")
        self.key = key

    def _quota_left(self) -> int:
        peer = self.store.get_peer(self.peer_id)
        negotiated = peer.bytes_negotiated if peer else 0
        received = peer.bytes_received if peer else 0
        return negotiated - received + defaults.PEER_OVERUSE_GRACE

    def _dest(self, file_info: wire.FileInfoKind, file_id: bytes) -> Path:
        if file_info == wire.FileInfoKind.INDEX:
            sub = "index"
        elif file_info == wire.FileInfoKind.SHARD:
            sub = "shard"  # file_id is the 13-byte shard id
        else:
            sub = "pack"
        return self.dir / sub / bytes(file_id).hex()

    def _check_part_admission(self, file_info: wire.FileInfoKind,
                              file_id: bytes, total: int) -> None:
        # refuse a chunked transfer up front when the whole file could
        # never fit the quota — don't burn disk on a doomed partial
        # (idempotent re-sends of an already-stored file are exempt:
        # the final sink acks those without re-counting)
        if not self._dest(file_info, file_id).exists() \
                and total > self._quota_left():
            raise P2PError("peer exceeded negotiated storage quota")

    async def sink(self, file_info: wire.FileInfoKind, file_id: bytes,
                   data: bytes) -> None:
        path = self._dest(file_info, file_id)
        d = path.parent
        loop = asyncio.get_running_loop()

        def persist() -> bool:
            """Blocking disk work off the event loop (the prover may be
            mid-backup itself: a slow disk here must not stall its own
            transfer plane).  Returns True if the file was new."""
            d.mkdir(parents=True, exist_ok=True)
            if path.exists():
                # Idempotent re-send: if the sender's ack was lost (crash
                # or drop between our write and their receive) it will
                # retry the identical file on a fresh session.  Same id +
                # same bytes => ack without re-counting quota; anything
                # else is still the collision refusal
                # (received_files_writer.rs:54-56).  XOR obfuscation is
                # deterministic, so comparing stored bytes against the
                # re-obfuscated payload is exact.
                if path.read_bytes() == obfuscate(data, self.key):
                    return False
                raise P2PError(f"refusing to overwrite {path.name}"
                               " with different bytes")
            if len(data) > self._quota_left():
                raise P2PError("peer exceeded negotiated storage quota")
            path.write_bytes(obfuscate(data, self.key))
            return True

        if await loop.run_in_executor(None, persist):
            self.store.add_peer_received(self.peer_id, len(data))

    def iter_stored(self):
        """Yield (file_info, file_id, de-obfuscated bytes) of everything this
        peer stored with us — the restore-serving source (restore_send.rs)."""
        for sub, kind in (("pack", wire.FileInfoKind.PACKFILE),
                          ("shard", wire.FileInfoKind.SHARD),
                          ("index", wire.FileInfoKind.INDEX)):
            d = self.dir / sub
            if not d.is_dir():
                continue
            for f in sorted(d.iterdir()):
                yield kind, bytes.fromhex(f.name), obfuscate(f.read_bytes(),
                                                             self.key)


class RestoreFilesWriter(_ResumableSinkMixin):
    """Save own packfiles/shards coming back from a peer during restore
    (restore_files_writer.rs).  ``base`` overrides the destination tree —
    sourceless shard repair stages its survivor fetches in a scratch dir
    instead of the restore dir."""

    def __init__(self, store: Store, base: Optional[object] = None):
        self.dir = Path(base) if base is not None else store.restore_dir()
        self.partials = PartialStore(self.dir / "partial")
        self.files = 0

    async def sink(self, file_info: wire.FileInfoKind, file_id: bytes,
                   data: bytes) -> None:
        if file_info == wire.FileInfoKind.INDEX:
            d = self.dir / "index"
            name = f"{int.from_bytes(bytes(file_id)[:8], 'little'):06d}"
        elif file_info == wire.FileInfoKind.SHARD:
            # shard/<packfile hex>/<index>: one directory per stripe so
            # assembly (erasure/stripe.py assemble_tree) can walk it
            pid, idx = bytes(file_id)[:-1], bytes(file_id)[-1]
            d = self.dir / "shard" / pid.hex()
            name = f"{idx:03d}"
        else:
            d = self.dir / "pack" / bytes(file_id).hex()[:2]
            name = bytes(file_id).hex()
        def persist() -> None:
            d.mkdir(parents=True, exist_ok=True)
            (d / name).write_bytes(data)

        # restore pulls run one Receiver per peer concurrently; the write
        # happens off the loop so one slow disk flush never stalls the
        # other peers' frames
        await asyncio.get_running_loop().run_in_executor(None, persist)
        self.files += 1


class P2PNode:
    """Ties rendezvous + transport together for one client."""

    def __init__(self, keys: KeyManager, store: Store, server_client,
                 bind_host: str = "127.0.0.1"):
        self.keys = keys
        self.store = store
        self.server = server_client
        self.bind_host = bind_host
        self.requests = ConnectionRequests()
        self._finalize_waiters: Dict[bytes, asyncio.Queue] = {}
        self.on_transport_request: Optional[Callable] = None
        self.on_restore_request: Optional[Callable] = None
        self.on_restore_fetch_request: Optional[Callable] = None
        self.on_audit_request: Optional[Callable] = None
        self.on_reclaim_request: Optional[Callable] = None
        server_client.on_incoming_p2p = self._handle_incoming
        server_client.on_finalize_p2p = self._handle_finalize

    # --- outgoing (accept_and_connect, handle_connections.rs:94-139) -------

    async def connect(self, peer_id: bytes, purpose: wire.RequestType,
                      timeout: float = 15.0) -> Transport:
        peer_id = bytes(peer_id)
        plane = faults.PLANE
        if plane is not None and (plane.is_dead(peer_id)
                                  or plane.is_dead(self.keys.client_id)):
            # fail fast, exactly like a dial to a vanished host; recorded
            # so the breach explainer sees kill evidence (obs/diagnose.py)
            dead = peer_id if plane.is_dead(peer_id) else self.keys.client_id
            faults._record_injection(f"dial.dead:{dead.hex()[:8]}")
            raise P2PError("injected: peer is dead")
        if plane is not None and plane.flaky_reconnect(peer_id):
            # the residential-NAT reconnect lottery: this dial attempt is
            # simply refused; the caller's resume loop retries
            raise P2PError("injected: flaky reconnect refused dial")
        nonce = self.requests.add(peer_id, purpose)
        q = self._finalize_waiters.setdefault(peer_id, asyncio.Queue())
        await self.server.p2p_connection_begin(peer_id, nonce)
        try:
            addr = await asyncio.wait_for(q.get(), timeout)
        except asyncio.TimeoutError:
            raise P2PError("peer did not confirm p2p connection")
        nonce, purpose = self.requests.finalize(peer_id)

        # dial retries (handle_connections.rs:145-165) through the unified
        # retry policy: 3 dials with jittered exponential backoff
        async def _dial():
            return await websockets.connect(
                f"ws://{addr}", max_size=defaults.MAX_P2P_MESSAGE_SIZE)

        try:
            ws = await retry.retry_async(_dial, retry.DIAL,
                                         retry_on=(OSError,))
        except OSError as e:
            raise P2PError(f"could not dial peer at {addr}: {e}") from e
        init = wire.P2PBody(
            kind=wire.P2PBodyKind.REQUEST,
            header=wire.P2PHeader(sequence_number=0, session_nonce=nonce),
            request_type=purpose)
        await ws.send(_sign_body(self.keys, init))
        t = Transport(ws, self.keys, peer_id, nonce)
        t.start()
        return t

    async def _handle_finalize(self, msg: wire.FinalizeP2PConnection) -> None:
        q = self._finalize_waiters.setdefault(
            bytes(msg.destination_client_id), asyncio.Queue())
        await q.put(msg.destination_ip_address)

    # --- incoming (accept_and_listen, handle_connections.rs:30-90) ---------

    async def _handle_incoming(self, msg: wire.IncomingP2PConnection) -> None:
        source = bytes(msg.source_client_id)
        plane = faults.PLANE
        if plane is not None and plane.is_dead(self.keys.client_id):
            return  # injected death: a dead host answers no rendezvous
        if self.store.get_peer(source) is None:
            return  # unknown peer: refuse (handle_connections.rs:31-45)
        expected_nonce = msg.session_nonce
        accepted: asyncio.Queue = asyncio.Queue()

        async def handler(ws):
            try:
                raw = await asyncio.wait_for(ws.recv(), 10)
                body = _verify_msg(raw, source)
                if (body.kind != wire.P2PBodyKind.REQUEST
                        or body.header.sequence_number != 0
                        or body.header.session_nonce != expected_nonce):
                    await ws.close()
                    return
            except (P2PError, asyncio.TimeoutError,
                    websockets.ConnectionClosed):
                return
            t = Transport(ws, self.keys, source, expected_nonce)
            t.start()
            done = asyncio.Event()
            await accepted.put((body.request_type, t, done))
            await done.wait()  # keep the ws handler alive while serving

        # random high port (net_p2p/mod.rs:26-35); the outer try/finally
        # guarantees the listener is closed even if this handler task is
        # cancelled mid-await (client shutdown)
        server = await websockets.serve(
            handler, self.bind_host, 0,
            max_size=defaults.MAX_P2P_MESSAGE_SIZE)
        try:
            port = server.sockets[0].getsockname()[1]
            await self.server.p2p_connection_confirm(
                source, f"{self.bind_host}:{port}")
            try:
                request_type, transport, done = await asyncio.wait_for(
                    accepted.get(), 30)
            except asyncio.TimeoutError:
                return
            try:
                if request_type == wire.RequestType.TRANSPORT:
                    if self.on_transport_request is not None:
                        await self.on_transport_request(source, transport)
                elif request_type == wire.RequestType.RESTORE_ALL:
                    if self.on_restore_request is not None:
                        await self.on_restore_request(source, transport)
                elif request_type == wire.RequestType.RESTORE_FETCH:
                    if self.on_restore_fetch_request is not None:
                        await self.on_restore_fetch_request(source, transport)
                elif request_type == wire.RequestType.AUDIT:
                    if self.on_audit_request is not None:
                        await self.on_audit_request(source, transport)
                elif request_type == wire.RequestType.RECLAIM:
                    if self.on_reclaim_request is not None:
                        await self.on_reclaim_request(source, transport)
            finally:
                done.set()
                await transport.close()
        finally:
            server.close()

    # --- restore serving (restore_send.rs) ---------------------------------

    async def serve_restore(self, peer_id: bytes, transport: Transport) -> int:
        """Stream everything ``peer_id`` stored with us back to them, with
        a per-peer rate limit (restore_send.rs:22-94)."""
        last = self.store.last_event_time(f"restore_served:{bytes(peer_id).hex()}")
        if last is not None and time.time() - last < defaults.RESTORE_REQUEST_THROTTLE_S:
            raise P2PError("restore request throttled")
        self.store.add_event(f"restore_served:{bytes(peer_id).hex()}", {})
        writer = ReceivedFilesWriter(self.store, peer_id)
        sent = 0
        for kind, file_id, data in writer.iter_stored():
            # chunked when large: a restore over a flaky WAN link resumes
            # instead of restarting (the puller passes a part-capable sink)
            await transport.send_file(data, kind, file_id)
            sent += 1
        return sent

    # --- shard-granular pull restore (docs/transfer.md restore data plane) --

    async def request_fetch(self, transport: Transport, wants) -> None:
        """Puller side: name the stored items wanted back on a
        RESTORE_FETCH connection.  ``wants`` is an iterable of
        ``(FileInfoKind, file_id)`` pairs; an INDEX want with an empty id
        asks for every index file the serving peer holds for us (the
        puller has no placement record of where its index files landed).
        Correlation is by connection, not sequence, so seq 0 is fine."""
        body = wire.P2PBody(
            kind=wire.P2PBodyKind.FETCH_REQUEST,
            header=wire.P2PHeader(sequence_number=0,
                                  session_nonce=transport.session_nonce),
            wants=tuple((wire.FileInfoKind(k), bytes(i))
                        for k, i in wants))
        await transport.send_body(body)

    async def serve_restore_fetch(self, peer_id: bytes,
                                  transport: Transport) -> int:
        """Serve one FETCH_REQUEST: stream exactly the named items back
        (skipping ones we don't hold — the puller notices the gap and
        re-queues on another holder).  Much lighter throttle than
        ``serve_restore``: a multi-source restore legitimately fans one
        client across many holders and hedges may revisit us."""
        peer_hex = bytes(peer_id).hex()
        last = self.store.last_event_time(f"restore_fetch_served:{peer_hex}")
        if last is not None and \
                time.time() - last < defaults.RESTORE_FETCH_MIN_INTERVAL_S:
            raise P2PError("restore fetch throttled")
        self.store.add_event(f"restore_fetch_served:{peer_hex}", {})
        writer = ReceivedFilesWriter(self.store, peer_id)
        body = await transport.recv_body(defaults.AUDIT_PROOF_TIMEOUT_S)
        if body.kind != wire.P2PBodyKind.FETCH_REQUEST:
            raise P2PError(
                "expected a FETCH_REQUEST body on a restore-fetch"
                " connection")
        if len(body.wants) > defaults.RESTORE_FETCH_MAX_WANTS:
            raise P2PError("too many items in one fetch request")
        loop = asyncio.get_running_loop()

        def _read(path: Path) -> bytes:
            return obfuscate(path.read_bytes(), writer.key)

        sent = 0
        with obs_trace.bind(getattr(body, "trace_id", None)), \
                obs_trace.span("restore.serve_fetch"):
            for kind, fid in body.wants:
                if kind == wire.FileInfoKind.INDEX and not fid:
                    d = writer.dir / "index"
                    names = sorted(
                        f.name for f in d.iterdir()) if d.is_dir() else []
                    for name in names:
                        data = await loop.run_in_executor(
                            None, _read, d / name)
                        await transport.send_file(
                            data, wire.FileInfoKind.INDEX,
                            bytes.fromhex(name))
                        sent += 1
                    continue
                path = writer._dest(kind, fid)
                if not path.exists():
                    continue
                data = await loop.run_in_executor(None, _read, path)
                await transport.send_file(data, kind, bytes(fid))
                sent += 1
        return sent

    # --- reclaim serving (GC's make-before-break tail, docs/lifecycle.md) ---

    async def request_reclaim(self, transport: Transport, items,
                              timeout: Optional[float] = None) -> int:
        """Owner side: ask the connected holder to delete the named
        superseded items.  ``items`` iterates ``(FileInfoKind, file_id)``
        pairs; returns the bytes the holder reports freed.  Correlation
        is the CHALLENGE/PROOF idiom — the ack echoes our sequence."""
        seq = transport.seq
        transport.seq += 1
        body = wire.P2PBody(
            kind=wire.P2PBodyKind.RECLAIM_REQUEST,
            header=wire.P2PHeader(sequence_number=seq,
                                  session_nonce=transport.session_nonce),
            wants=tuple((wire.FileInfoKind(k), bytes(i))
                        for k, i in items))
        await transport.send_body(body)
        reply = await transport.recv_body(
            defaults.AUDIT_PROOF_TIMEOUT_S if timeout is None else timeout)
        if reply.kind != wire.P2PBodyKind.RECLAIM_ACK \
                or reply.header.sequence_number != seq:
            raise P2PError("expected a RECLAIM_ACK echoing our sequence")
        return int(reply.offset)

    async def serve_reclaim(self, peer_id: bytes,
                            transport: Transport) -> int:
        """Serve one RECLAIM_REQUEST: delete the named items the signed
        requester itself stored with us, credit the freed bytes back
        against its quota, and ack with the byte count.

        Deletion scope is bounded by identity: paths resolve strictly
        under ``received_dir(peer_id)`` via the same ``_dest`` mapping
        the receive path uses, so a peer can only ever reclaim its OWN
        placements.  Unknown ids are skipped, not errors — the owner
        retries from its persisted backlog and an already-deleted file
        simply contributes zero bytes (idempotent re-delivery)."""
        peer_hex = bytes(peer_id).hex()
        last = self.store.last_event_time(f"reclaim_served:{peer_hex}")
        if last is not None and \
                time.time() - last < defaults.RECLAIM_MIN_INTERVAL_S:
            _RECLAIM_REQUESTS.inc(outcome="throttled")
            raise P2PError("reclaim request throttled")
        self.store.add_event(f"reclaim_served:{peer_hex}", {})
        writer = ReceivedFilesWriter(self.store, peer_id)
        body = await transport.recv_body(defaults.AUDIT_PROOF_TIMEOUT_S)
        if body.kind != wire.P2PBodyKind.RECLAIM_REQUEST:
            _RECLAIM_REQUESTS.inc(outcome="bad_body")
            raise P2PError(
                "expected a RECLAIM_REQUEST body on a reclaim connection")
        if len(body.wants) > defaults.RECLAIM_MAX_ITEMS:
            _RECLAIM_REQUESTS.inc(outcome="too_many")
            raise P2PError("too many items in one reclaim request")
        loop = asyncio.get_running_loop()

        def _unlink() -> int:
            freed = 0
            for kind, fid in body.wants:
                path = writer._dest(kind, fid)
                try:
                    size = path.stat().st_size
                    path.unlink()
                    freed += size
                except OSError:
                    continue  # unknown or already gone: zero bytes
            return freed

        freed = await loop.run_in_executor(None, _unlink)
        if freed:
            # the deleted bytes stop counting against the peer's quota
            # (clamped: a replayed delete cannot mint free storage)
            self.store.credit_peer_received(peer_id, freed)
            _RECLAIM_BYTES_FREED.inc(freed)
        _RECLAIM_REQUESTS.inc(outcome="ok")
        reply = wire.P2PBody(
            kind=wire.P2PBodyKind.RECLAIM_ACK,
            header=wire.P2PHeader(
                sequence_number=body.header.sequence_number,
                session_nonce=transport.session_nonce),
            acked_sequence=body.header.sequence_number,
            offset=freed)
        await transport.send_body(reply)
        return freed

    # --- audit serving (prover side of the storage attestation) ------------

    async def serve_audit(self, peer_id: bytes, transport: Transport,
                          backend) -> int:
        """Answer one storage-audit challenge batch from ``peer_id``.

        The verifier opens an AUDIT-purpose connection, sends a single
        CHALLENGE body, and expects one PROOF body echoing its sequence
        number.  Per-peer rate limiting mirrors ``serve_restore`` so a
        hostile verifier cannot turn us into a free hashing oracle.
        """
        from ..audit.prover import compute_proofs  # local: avoids cycle

        peer_hex = bytes(peer_id).hex()
        last = self.store.last_event_time(f"audit_served:{peer_hex}")
        if last is not None and \
                time.time() - last < defaults.AUDIT_SERVE_MIN_INTERVAL_S:
            raise P2PError("audit request throttled")
        self.store.add_event(f"audit_served:{peer_hex}", {})
        body = await transport.recv_body(defaults.AUDIT_PROOF_TIMEOUT_S)
        if body.kind != wire.P2PBodyKind.CHALLENGE:
            raise P2PError("expected a CHALLENGE body on an audit connection")
        if len(body.challenges) > defaults.AUDIT_MAX_CHALLENGES_PER_MSG:
            raise P2PError("too many challenges in one message")
        # join the verifier's audit trace (challenge -> proof in one id)
        with obs_trace.bind(getattr(body, "trace_id", None)), \
                obs_trace.span("audit.serve"):
            proofs = compute_proofs(self.store, backend, peer_id,
                                    body.challenges)
        reply = wire.P2PBody(
            kind=wire.P2PBodyKind.PROOF,
            header=wire.P2PHeader(
                sequence_number=body.header.sequence_number,
                session_nonce=transport.session_nonce),
            proofs=tuple(proofs))
        await transport.send_body(reply)
        return len(proofs)
