"""Coordination server: identity, matchmaking, rendezvous, snapshot registry.

Counterpart of ``backuwup_tpu/net/server.py``, copied so that the port
imports nothing of the JAX package. Its routes, JSON messages and metric
names are the reference's, so clients of either package talk to it.

Re-designs the reference server (``server/src/``) on aiohttp.  The control
plane never touches backup data (SURVEY.md §1): it does

* **challenge-response auth** on Ed25519 client keys — 30 s challenge TTL,
  24 h session TTL (``client_auth_manager.rs:17-20,49-101``),
* **storage-request matchmaking** — an expiring queue; ``fulfill`` pops
  candidates, matches ``min(remaining, candidate)``, notifies both clients
  over their push channels, records the negotiation in both directions, and
  re-enqueues remainders (``backup_request.rs:73-185``),
* **P2P rendezvous relay** — forwards connection requests/confirmations
  between clients (``handlers/p2p_connection_request.rs``),
* **snapshot registry** — latest snapshot hash per client plus the peer
  list needed for restore (``db.rs:129-187``, ``handlers/backup.rs``).

Since PR 10 the process is structured as a **stateless request tier** over
two swappable planes (docs/server.md):

* persistent state behind :class:`~.serverstore.ServerStore` — by default
  the write-behind :class:`~.serverstore.SqliteServerStore`, whose commits
  run on a dedicated writer thread with group commit; handlers ``await
  store.aio.*`` so a response that promises durability is only written
  after the commit, and the event loop never blocks on sqlite;
* matchmaking in :class:`~.matchmaking.ShardedMatchmaker` — N
  pubkey-sharded in-memory queues with per-shard locks, deadline-heap
  expiry, and cross-shard work stealing.

``CoordinationServer(legacy=True)`` assembles the pre-PR-10 shape (the
direct-commit :class:`~.serverstore.ServerDB` plus the single-lock
:class:`StorageQueue`) as the measured baseline for bench config
``12_swarm``.
"""

from __future__ import annotations

import asyncio
import os
import time
import urllib.request
from typing import Dict, List, Optional, Set

import json

import aiohttp
from aiohttp import WSMsgType, web

from .. import defaults, wire
from ..crypto import verify_signature
from ..obs import expo as obs_expo
from ..obs import invariants as obs_invariants
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from .matchmaking import (_MATCHMAKINGS, _QUEUE_DEPTH,  # noqa: F401
                          ShardedMatchmaker)
from .ring import partition_key, successors as ring_successors
from .serverstore import (_MIGRATIONS, _SCHEMA, SCHEMA_VERSION,  # noqa: F401
                          ReplicatedServerStore, ReplicationFenced,
                          ServerDB, ServerStore, SqliteServerStore)

_REQUESTS = obs_metrics.counter(
    "bkw_server_requests_total", "Coordination-server requests by route",
    ("path",))
_REQUEST_SECONDS = obs_metrics.histogram(
    "bkw_server_request_seconds",
    "Coordination-server request latency by canonical route",
    ("route",))
_CONNECTED = obs_metrics.gauge(
    "bkw_server_connected_clients", "Clients on the WS push channel")

# Federation plane (docs/server.md §Federation).  Steal attempts are
# counted once per fulfill-side remote leg (hit/miss/error), serves once
# per /fed/steal RPC answered (hit/empty) — a federated pairing shows up
# as exactly one serve hit on the serving node and one steal hit on the
# requesting node.
_FED_STEALS = obs_metrics.counter(
    "bkw_federation_steals_total",
    "Requester-side cross-node steal attempts by outcome"
    " (hit/miss/error)", ("outcome",))
_FED_STEAL_SERVED = obs_metrics.counter(
    "bkw_federation_steal_served_total",
    "Serving-side /fed/steal RPCs answered by outcome (hit/empty)",
    ("outcome",))
_FED_RPC_SECONDS = obs_metrics.histogram(
    "bkw_federation_rpc_seconds",
    "Inter-node federation RPC latency by op", ("op",))
_FED_NOTIFY_RELAYS = obs_metrics.counter(
    "bkw_federation_notify_relays_total",
    "WS pushes relayed to another node's client by outcome"
    " (delivered/failed)", ("outcome",))
_RING_NODES = obs_metrics.gauge(
    "bkw_ring_nodes", "Coordination nodes on this node's hash ring")
_RING_REDIRECTS = obs_metrics.counter(
    "bkw_ring_redirects_total",
    "Wrong-node arrivals answered with a NodeRedirect (HTTP 421)")

# Families the clients of this process produce into; declared here too
# (get-or-create merges them) so a standalone server's /metrics always
# advertises the core catalog even before any client code is imported.
obs_metrics.histogram("bkw_transfer_send_seconds",
                      "Seconds spent in ws.send + ack per transfer")
obs_metrics.counter("bkw_audit_total", "Audit verdicts by outcome",
                    ("outcome",))
obs_metrics.counter("bkw_repair_rounds_total", "Peer-loss repair rounds run")


class AuthManager:
    """Challenges (30 s) and session tokens (24 h) with expiry
    (client_auth_manager.rs)."""

    def __init__(self):
        self._challenges: Dict[bytes, tuple] = {}  # pubkey -> (nonce, expiry)
        self._sessions: Dict[bytes, tuple] = {}  # token -> (pubkey, expiry)

    def challenge_begin(self, pubkey: bytes) -> bytes:
        nonce = os.urandom(wire.CHALLENGE_NONCE_LEN)
        self._challenges[pubkey] = (
            nonce, time.time() + defaults.AUTH_CHALLENGE_TTL_S)
        return nonce

    def take_challenge(self, pubkey: bytes) -> Optional[bytes]:
        """Pop a live challenge nonce; None when absent/expired (the
        reference distinguishes ChallengeNotFound -> Retry from a bad
        signature -> BadRequest, handlers/mod.rs:52-76)."""
        entry = self._challenges.pop(pubkey, None)
        if entry is None or entry[1] < time.time():
            return None
        return entry[0]

    def session_start(self, pubkey: bytes) -> bytes:
        token = os.urandom(wire.SESSION_TOKEN_LEN)
        self._sessions[token] = (pubkey, time.time() + defaults.SESSION_TTL_S)
        return token

    def get_session(self, token: Optional[bytes]) -> Optional[bytes]:
        if token is None:
            return None
        entry = self._sessions.get(bytes(token))
        if entry is None or entry[1] < time.time():
            self._sessions.pop(bytes(token), None)
            return None
        return entry[0]


class Connections:
    """client-id -> WS push sink registry (server/src/ws.rs:73-109).

    With federation enabled, ``relay`` is an async
    ``(client_id, msg) -> bool`` hook consulted when the client has no
    LOCAL socket: the push is forwarded to the node that does hold it
    (/fed/notify), so p2p rendezvous, AuditDue nudges, and steal-served
    matches reach clients wherever they (re)connected.  ``is_online``
    stays local on purpose — it gates queue admission, and a remote
    socket's liveness is the remote node's business.
    """

    def __init__(self):
        self._socks: Dict[bytes, web.WebSocketResponse] = {}
        self.relay = None

    def register(self, client_id: bytes, ws: web.WebSocketResponse) -> None:
        self._socks[bytes(client_id)] = ws
        _CONNECTED.set(len(self._socks))

    def unregister(self, client_id: bytes, ws: web.WebSocketResponse) -> None:
        if self._socks.get(bytes(client_id)) is ws:
            self._socks.pop(bytes(client_id), None)
        _CONNECTED.set(len(self._socks))

    def count(self) -> int:
        return len(self._socks)

    def is_online(self, client_id: bytes) -> bool:
        return bytes(client_id) in self._socks

    async def notify_local(self, client_id: bytes,
                           msg: wire.JsonMessage) -> bool:
        """Push to a locally connected socket only (the /fed/notify
        handler terminates here — a relay must never re-relay)."""
        ws = self._socks.get(bytes(client_id))
        if ws is None or ws.closed:
            return False
        try:
            await ws.send_str(msg.to_json())
            return True
        except (ConnectionError, RuntimeError):
            self._socks.pop(bytes(client_id), None)
            return False

    async def notify(self, client_id: bytes, msg: wire.JsonMessage) -> bool:
        if await self.notify_local(client_id, msg):
            return True
        if self.relay is not None:
            return await self.relay(bytes(client_id), msg)
        return False


class StorageQueue:
    """The original single-lock matchmaking economy (backup_request.rs):
    an expiring list of (client, bytes-wanted) fulfilled by pairing
    clients with each other.

    Retained as the measured baseline for the sharded matchmaker
    (``CoordinationServer(legacy=True)``, bench config ``12_swarm``) and
    because its semantics tests pin the matchmaking contract both
    implementations honor.  Structural costs, by design: ``_lock`` is
    held across the WHOLE fulfill — db writes and WS pushes included —
    and expiry rescans the list front on every pop."""

    def __init__(self, db, connections: Connections,
                 expiry_s: float = None):
        self.db = db
        self.connections = connections
        self.expiry_s = (defaults.BACKUP_REQUEST_EXPIRY_S
                         if expiry_s is None else expiry_s)
        self._queue: list = []  # (client_id, remaining, expires_at)
        self._lock = asyncio.Lock()

    def _pop_valid(self) -> Optional[tuple]:
        now = time.time()
        while self._queue:
            client, remaining, expires = self._queue.pop(0)
            if expires >= now and self.connections.is_online(client):
                return client, remaining, expires
        return None

    async def fulfill(self, client_id: bytes, storage_required: int,
                      min_peers: int = 1) -> None:
        """Match against queued requests; both sides get BackupMatched for
        min(remaining, candidate); remainders re-enqueue
        (backup_request.rs:73-185).

        ``min_peers > 1`` is the erasure-stripe hint: the requester wants
        its grant spread over at least that many DISTINCT peers (a stripe
        needs k+m holders), so each match is capped at an even share
        instead of letting one storage-rich candidate swallow the whole
        request.  The cap only applies while the queue holds enough other
        candidates to plausibly reach the spread — with a shallower queue
        it falls back to greedy matching, so 2–3-client deployments see
        exactly the pre-erasure behavior.
        """
        if storage_required > defaults.MAX_BACKUP_STORAGE_REQUEST_SIZE:
            raise ValueError("storage request exceeds protocol cap")
        min_peers = max(int(min_peers), 1)
        async with self._lock:
            share_cap = None
            if min_peers > 1:
                others = {c for c, _r, _e in self._queue
                          if c != bytes(client_id)}
                if len(others) >= min_peers:
                    share_cap = -(-storage_required // min_peers)
            remaining = storage_required
            while remaining > 0:
                entry = self._pop_valid()
                if entry is None:
                    break
                candidate, cand_remaining, cand_expires = entry
                if candidate == bytes(client_id):
                    continue  # self-match discarded
                if self.db.audit_failing_reporters(
                        candidate, defaults.AUDIT_REPORT_WINDOW_S) \
                        >= defaults.AUDIT_SERVER_BLOCK_FAILURES:
                    # Independently reported as failing storage audits:
                    # drop its queued request rather than hand it new data.
                    continue
                match = min(remaining, cand_remaining)
                if share_cap is not None:
                    match = min(match, share_cap)
                # Record the negotiation FIRST, then push: a client must
                # never learn of a match the server does not persist (a
                # notified candidate would start treating the requester as a
                # negotiated peer while get_client_negotiated_peers denies
                # it).  A failed candidate push rolls the record back; the
                # reference instead records after notify
                # (backup_request.rs:95-139) and carries that window.
                # Known residual window: a server CRASH between the save and
                # the notify leaves a phantom record neither client knows
                # about.  That is harmless on the send path (the peer simply
                # never dials) and tolerated on restore: the phantom peer
                # refuses the dial as an unknown peer, and the client
                # proceeds anyway when the data from the remaining peers
                # covers the snapshot (engine._restored_coverage_gap).
                self.db.save_storage_negotiated(bytes(client_id), candidate,
                                                match)
                self.db.save_storage_negotiated(candidate, bytes(client_id),
                                                match)
                ok_cand = await self.connections.notify(
                    candidate, wire.BackupMatched(
                        destination_id=bytes(client_id),
                        storage_available=match))
                if not ok_cand:
                    # Candidate unreachable: roll back, drop its queued
                    # request, and try the next one
                    # (backup_request.rs:166-173).
                    self.db.delete_storage_negotiated(
                        bytes(client_id), candidate, match)
                    self.db.delete_storage_negotiated(
                        candidate, bytes(client_id), match)
                    continue
                _MATCHMAKINGS.inc()
                ok_self = await self.connections.notify(
                    bytes(client_id), wire.BackupMatched(
                        destination_id=candidate, storage_available=match))
                if not ok_self:
                    # The requester is unreachable but the candidate has
                    # already been told: keep the record (both sides stay
                    # consistent; the requester discovers the peer on its
                    # next restore/reconnect), re-enqueue the candidate's
                    # remainder, and stop matching for the dead requester.
                    cand_remaining -= match
                    if cand_remaining > 0:
                        self._queue.append((candidate, cand_remaining,
                                            cand_expires))
                    return
                remaining -= match
                cand_remaining -= match
                if cand_remaining > 0:
                    self._queue.append((candidate, cand_remaining,
                                        cand_expires))
            if remaining > 0:
                self._queue.append((bytes(client_id), remaining,
                                    time.time() + self.expiry_s))
            _QUEUE_DEPTH.set(len(self._queue))

    def pending(self) -> int:
        depth = len(self._queue)
        _QUEUE_DEPTH.set(depth)  # point-in-time refresh for scrapers
        return depth


@web.middleware
async def _obs_middleware(request, handler):
    """Per-request observability: count and time by canonical route
    (bounded label cardinality — the route table, not raw paths) and
    adopt the client's trace id from the POST JSON so the server-side
    span journals under the same id as the caller's.  The latency lands
    in ``bkw_server_request_seconds{route}``; the swarm scorecard and
    bench config 12 read their p99 from its buckets."""
    resource = request.match_info.route.resource
    path = resource.canonical if resource is not None else request.path
    _REQUESTS.inc(path=path)
    trace_id = None
    if request.method == "POST" and request.can_read_body:
        try:
            # request.text() caches: handlers re-read the same body
            trace_id = json.loads(await request.text()).get("trace_id")
        except (ValueError, UnicodeDecodeError):
            pass
    t0 = time.monotonic()
    try:
        with obs_trace.bind(trace_id), obs_trace.span(f"server{path}"):
            return await handler(request)
    except ReplicationFenced as e:
        # a zombie primary's write was refused by a higher-epoch chain:
        # flip the local owner table and steer the client to the node
        # that fenced us (it is either the new owner or knows it)
        srv = request.app.get("bkw_server")
        if srv is not None and e.owner and e.partition is not None \
                and isinstance(srv.db, ReplicatedServerStore):
            srv.db.set_owner(e.partition, e.owner)
        url = srv.peers.get(e.owner) if (srv is not None and e.owner) \
            else None
        if url:
            _RING_REDIRECTS.inc()
            raise web.HTTPMisdirectedRequest(
                text=wire.NodeRedirect(url=url).to_json(),
                content_type="application/json")
        raise web.HTTPConflict(
            text=wire.Error(kind=wire.ErrorKind.RETRY,
                            detail=str(e)).to_json(),
            content_type="application/json")
    finally:
        _REQUEST_SECONDS.observe(time.monotonic() - t0, route=path)


class CoordinationServer:
    """The stateless request tier.

    Handlers keep no cross-request state beyond the auth/session maps
    and the live WS registry; persistent state is behind ``self.db`` (a
    :class:`~.serverstore.ServerStore`) and queueing behind
    ``self.queue``.  Durable writes go through ``self.db.aio`` — in the
    default write-behind store the await resolves only after the group
    commit, so the durability-promising responses (registration, login
    bookkeeping, snapshot registration, audit/repair verdicts,
    negotiation records) are acknowledged only once committed, without
    ever running a sqlite commit on the event loop.

    ``legacy=True`` assembles the pre-PR-10 single-lock shape over a
    direct-commit store — the bench baseline.  ``store=`` injects any
    other :class:`~.serverstore.ServerStore` implementation.
    """

    def __init__(self, db_path=":memory:", store: Optional[ServerStore] = None,
                 legacy: bool = False, shards: Optional[int] = None):
        # An injected store has a wider lifecycle than this server: a
        # federated deployment shares one PartitionedServerStore across
        # node instances (and node revive reuses it), so stop() only
        # closes stores this instance constructed.
        self._owns_store = store is None
        if store is None:
            store = (ServerDB(db_path) if legacy
                     else SqliteServerStore(db_path))
        self.db = store
        self.legacy = bool(legacy)
        self.auth = AuthManager()
        self.connections = Connections()
        if legacy:
            self.queue = StorageQueue(self.db, self.connections)
        else:
            self.queue = ShardedMatchmaker(self.db, self.connections,
                                           shards=shards)
        self._runner: Optional[web.AppRunner] = None
        self.port: Optional[int] = None
        self._started = time.time()
        # federation state (dormant until enable_federation)
        self.node_id: Optional[str] = None
        self.ring = None
        self.peers: Dict[str, str] = {}
        self._fed_http: Optional[aiohttp.ClientSession] = None
        self._peer_down_until: Dict[str, float] = {}
        self._steal_cooldown_until = 0.0
        # replication state (dormant unless the store is replicated)
        self._repl_chains: Dict[int, List[str]] = {}
        self._probe_task: Optional[asyncio.Task] = None
        self._probe_fail: Dict[str, int] = {}
        self._dead_nodes: Set[str] = set()

    # --- helpers -----------------------------------------------------------

    _STATUS_EXC = {400: web.HTTPBadRequest, 401: web.HTTPUnauthorized,
                   404: web.HTTPNotFound, 409: web.HTTPConflict,
                   500: web.HTTPInternalServerError}

    @staticmethod
    def _err(kind: str, detail: str = "",
             status: Optional[int] = None) -> web.HTTPException:
        """Typed error response: one of the 8 wire.ErrorKind payloads at
        its mapped HTTP status (handlers/mod.rs:50-91)."""
        status = status or wire.ERROR_HTTP_STATUS[kind]
        exc = CoordinationServer._STATUS_EXC[status]
        return exc(text=wire.Error(kind=kind, detail=detail).to_json(),
                   content_type="application/json")

    def _session(self, msg) -> bytes:
        client = self.auth.get_session(msg.session_token)
        if client is None:
            raise self._err(wire.ErrorKind.UNAUTHORIZED)
        return client

    @staticmethod
    async def _parse(request, cls):
        try:
            msg = wire.JsonMessage.from_json(await request.text())
        except (ValueError, KeyError) as e:
            raise CoordinationServer._err(wire.ErrorKind.BAD_REQUEST, str(e))
        if not isinstance(msg, cls):
            raise CoordinationServer._err(
                wire.ErrorKind.BAD_REQUEST, f"expected {cls.__name__}")
        return msg

    @staticmethod
    def _ok(msg: wire.JsonMessage = None) -> web.Response:
        return web.Response(text=(msg or wire.Ok()).to_json(),
                            content_type="application/json")

    # --- federation (docs/server.md §Federation) ----------------------------

    def enable_federation(self, node_id: str, ring, peers: Dict[str, str]
                          ) -> None:
        """Join this node to a federated deployment.

        ``ring`` is the shared :class:`~.ring.HashRing` (every node and
        client computes the identical ring from the node list);
        ``peers`` maps node id -> base URL for every node, this one
        included.  Call after :meth:`start` (peer URLs carry the
        OS-assigned ports).  Wires up:

        * the matchmaker's ``remote_steal`` leg — consulted only once
          every local shard is empty, walking ``ring.steal_order`` with
          per-peer dial backoff;
        * WS push relay — pushes for clients connected elsewhere are
          forwarded over /fed/notify, owner node first;
        * wrong-node redirects — session-less entry points answer 421
          with the owner's URL when the arrival is misrouted.

        Trust model: /fed/* is unauthenticated — federation assumes a
        private inter-node network, same trust boundary as the shared
        store files.
        """
        self.node_id = str(node_id)
        self.ring = ring
        self.peers = {str(n): u.rstrip("/") for n, u in peers.items()
                      if str(n) != self.node_id}
        if isinstance(self.queue, ShardedMatchmaker):
            self.queue.remote_steal = self._remote_steal
        self.connections.relay = self._relay_notify
        _RING_NODES.set(len(ring))
        if isinstance(self.db, ReplicatedServerStore):
            self._wire_replication()

    # --- replication (docs/server.md §Replication) ---------------------------

    def _partition_order(self, partition: int) -> List[str]:
        """Takeover seniority for a partition: its ring owner, then the
        ring successors — the same order every node computes, so exactly
        one live node concludes it is next in line."""
        owner = self.ring.owner(partition_key(partition))
        order = [owner] if owner is not None else []
        return order + [n for n in self.ring.steal_order(owner or "")
                        if n not in order]

    def _partition_chain(self, partition: int) -> List[str]:
        """Successor chain from THIS node's perspective: the next
        ``REPL_SUCCESSORS`` seniority members after wherever this node
        sits, which after a takeover deliberately still includes the
        original (dead) owner — ships to it fail harmlessly under
        backoff until the zombie revives, at which point the first ship
        re-fences it and it rejoins as a successor."""
        order = [n for n in self._partition_order(partition)
                 if n != self.node_id]
        return order[:defaults.REPL_SUCCESSORS]

    def _wire_replication(self) -> None:
        store = self.db
        owners: Dict[int, str] = {}
        chains: Dict[int, List[str]] = {}
        for i in range(len(store.parts)):
            owners[i] = self.ring.owner(partition_key(i)) or self.node_id
            chains[i] = (ring_successors(self.ring, i)
                         if owners[i] == self.node_id else [])
            self._repl_chains[i] = chains[i]
        store.set_topology(owners=owners, successors=chains,
                           ship=self._repl_ship)
        store.forward_sync = self._repl_forward_sync
        store.forward_async = self._repl_forward_async
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None and self.peers:
            self._probe_task = loop.create_task(self._probe_loop())

    def _repl_url(self, node_id: str, path: str) -> str:
        url = self.peers.get(node_id)
        if url is None:
            raise ConnectionError(f"unknown peer {node_id!r}")
        return url + path

    def _repl_ship(self, node_id: str, payload: dict) -> dict:
        """Sync ship hook for the store's WRITER THREAD (never the event
        loop): POST one log tail to a successor's /repl/ship.  Synchrony
        is the point — the batch's futures must not resolve until the
        successor's ack (or a deliberate degraded decision) is in."""
        req = urllib.request.Request(
            self._repl_url(node_id, "/repl/ship"),
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(
                req, timeout=defaults.REPL_SHIP_TIMEOUT_S) as resp:
            return json.loads(resp.read())

    def _repl_forward_sync(self, node_id: str, body: dict) -> dict:
        req = urllib.request.Request(
            self._repl_url(node_id, "/repl/forward"),
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(
                req, timeout=defaults.FEDERATION_RPC_TIMEOUT_S) as resp:
            return json.loads(resp.read())

    async def _repl_post(self, node_id: str, path: str, body: dict,
                         op: str) -> dict:
        """Replication RPC: like :meth:`_fed_post` but WITHOUT the
        peer-down negative cache — a forward's owner (or a promote's
        reconciliation source) is the only correct target, so failing
        fast for the whole backoff window would turn one timed-out RPC
        into seconds of refused writes.  Raises instead of None."""
        url = self.peers.get(node_id)
        if url is None:
            raise ConnectionError(f"unknown peer {node_id!r}")
        body = dict(body, trace_id=obs_trace.current_trace_id())
        t0 = time.monotonic()
        try:
            async with self._fed_session().post(
                    url + path, json=body,
                    timeout=aiohttp.ClientTimeout(
                        total=defaults.REPL_FORWARD_TIMEOUT_S)) as resp:
                doc = await resp.json()
            if resp.status != 200:
                raise ConnectionError(
                    f"{path} to {node_id!r}: HTTP {resp.status}")
            return doc
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            # str(asyncio.TimeoutError()) is empty — name the type so
            # the log line says WHAT failed, not just that it did
            raise ConnectionError(
                f"{path} to {node_id!r} failed:"
                f" {e or type(e).__name__}") from e
        finally:
            _FED_RPC_SECONDS.observe(time.monotonic() - t0, op=op)

    async def _repl_forward_async(self, node_id: str, body: dict) -> dict:
        return await self._repl_post(node_id, "/repl/forward", body,
                                     op="forward")

    async def _probe_peer(self, node_id: str) -> bool:
        """One liveness probe: any HTTP answer (even an unhealthy 503)
        means the process is alive — promotion is for DEAD primaries,
        not degraded ones."""
        url = self.peers.get(node_id)
        if url is None:
            return False
        try:
            async with self._fed_session().get(url + "/healthz") as resp:
                await resp.read()
            return True
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            return False

    async def _probe_loop(self) -> None:
        while True:
            await asyncio.sleep(defaults.REPL_PROBE_INTERVAL_S)
            try:
                await self._probe_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # probes must never kill the loop
                continue

    async def _probe_once(self) -> None:
        store = self.db
        # who do we care about? every current owner of a partition whose
        # chain we sit on, plus everyone senior to us there (we defer to
        # a live senior rather than racing it to promote)
        for node in list(self.peers):
            if await self._probe_peer(node):
                self._probe_fail[node] = 0
                self._dead_nodes.discard(node)
            else:
                self._probe_fail[node] = self._probe_fail.get(node, 0) + 1
                if self._probe_fail[node] >= defaults.REPL_PROBE_FAILURES:
                    self._dead_nodes.add(node)
        for i in range(len(store.parts)):
            owner = store.owners.get(i)
            if owner == self.node_id or owner not in self._dead_nodes:
                continue
            order = self._partition_order(i)
            if self.node_id not in order:
                continue
            seniors = order[:order.index(self.node_id)]
            if any(n != owner and n not in self._dead_nodes
                   for n in seniors):
                continue  # a live senior will take it
            await self._promote_partition(i)

    async def _promote_partition(self, partition: int) -> None:
        """Promote-on-death: reconcile the log with the surviving chain
        members, replay the tail, assume ownership, re-chain, announce.

        Reconciliation first: the dead primary needed only ONE ack per
        batch, so a sibling successor may hold acked records this node
        never saw.  Pull every live chain member's tail past our lsn and
        merge it (accept_ship dedupes) BEFORE the epoch bump — promoting
        around the longest surviving log is what makes 'acked by >=1
        live successor' equal 'survives the primary's death'."""
        part = self.db.parts[partition]
        order = [n for n in self._partition_order(partition)
                 if n != self.node_id]
        for node in order[:defaults.REPL_SUCCESSORS + 1]:
            if node in self._dead_nodes:
                continue
            # a live sibling may hold the ONLY surviving copy of an
            # acked record, so one failed pull gets one retry before
            # this node promotes around a shorter log
            doc = None
            for attempt in (0, 1):
                try:
                    doc = await self._repl_post(
                        node, "/repl/tail",
                        {"partition": int(partition),
                         "after_lsn": part.log.last_lsn}, op="tail")
                    break
                except ConnectionError:
                    if attempt == 0:
                        await asyncio.sleep(0.2)
            if doc is None:
                continue
            if doc.get("records"):
                await asyncio.to_thread(self.db.accept_ship, {
                    "partition": int(partition),
                    "epoch": max(int(doc.get("epoch", 0)),
                                 part.log.epoch),
                    "from_lsn": part.log.last_lsn + 1,
                    "records": doc["records"]})
        epoch = await asyncio.to_thread(self.db.promote, partition)
        chain = self._partition_chain(partition)
        self._repl_chains[partition] = chain
        self.db.set_topology(successors={partition: chain},
                             ship=self._repl_ship)
        body = {"partition": int(partition), "epoch": int(epoch),
                "owner": self.node_id}
        for node in list(self.peers):
            await self._fed_post(node, "/repl/promote", body, op="promote")

    async def repl_ship(self, request):
        """Inter-node RPC: successor intake for one shipped log tail
        (store-level accept_ship does epoch fencing, gap detection, and
        the durable append — on the writer-pool thread, never here)."""
        if not isinstance(self.db, ReplicatedServerStore):
            raise self._err(wire.ErrorKind.BAD_REQUEST,
                            "replication not enabled")
        try:
            doc = json.loads(await request.text())
            resp = await asyncio.to_thread(self.db.accept_ship, doc)
        except (ValueError, KeyError, TypeError, IndexError) as e:
            raise self._err(wire.ErrorKind.BAD_REQUEST, str(e))
        return web.json_response(resp)

    async def repl_promote(self, request):
        """Inter-node RPC: a promotion announcement.  Adopt the new
        owner for the partition when the epoch is no older than ours —
        a zombie primary hearing this learns it was superseded."""
        if not isinstance(self.db, ReplicatedServerStore):
            raise self._err(wire.ErrorKind.BAD_REQUEST,
                            "replication not enabled")
        try:
            doc = json.loads(await request.text())
            partition = int(doc["partition"])
            epoch = int(doc["epoch"])
            owner = str(doc["owner"])
            part = self.db.parts[partition]
        except (ValueError, KeyError, TypeError, IndexError) as e:
            raise self._err(wire.ErrorKind.BAD_REQUEST, str(e))
        if epoch >= part.log.epoch:
            was_owner = self.db.owners.get(partition) == self.node_id
            self.db.set_owner(partition, owner)
            if owner != self.node_id and was_owner:
                # we were the primary and just learned we are not: stop
                # accepting writes NOW, not at the next fenced ship
                part.fenced = True
        return web.json_response({"ok": True, "epoch": part.log.epoch})

    async def repl_tail(self, request):
        """Inter-node RPC: read this node's log records past a given
        lsn for one partition — the promote-time reconciliation pull."""
        if not isinstance(self.db, ReplicatedServerStore):
            raise self._err(wire.ErrorKind.BAD_REQUEST,
                            "replication not enabled")
        try:
            doc = json.loads(await request.text())
            resp = await asyncio.to_thread(
                self.db.log_tail, int(doc["partition"]),
                int(doc["after_lsn"]))
        except (ValueError, KeyError, TypeError, IndexError) as e:
            raise self._err(wire.ErrorKind.BAD_REQUEST, str(e))
        return web.json_response(resp)

    async def repl_forward(self, request):
        """Inter-node RPC: execute one store op on a LOCAL partition for
        a node that does not own it (the store's forward hooks land
        here).  Never re-forwards — a stale sender gets wrong_owner."""
        if not isinstance(self.db, ReplicatedServerStore):
            raise self._err(wire.ErrorKind.BAD_REQUEST,
                            "replication not enabled")
        try:
            doc = json.loads(await request.text())
            resp = await asyncio.to_thread(
                self.db.execute_local, int(doc["partition"]),
                str(doc["op"]), list(doc.get("args") or []))
        except (ValueError, KeyError, TypeError, IndexError) as e:
            raise self._err(wire.ErrorKind.BAD_REQUEST, str(e))
        return web.json_response(resp)

    def _fed_session(self) -> aiohttp.ClientSession:
        if self._fed_http is None or self._fed_http.closed:
            self._fed_http = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(
                    total=defaults.FEDERATION_RPC_TIMEOUT_S))
        return self._fed_http

    def _peer_down(self, node_id: str) -> bool:
        return self._peer_down_until.get(node_id, 0.0) > time.monotonic()

    def _mark_peer_down(self, node_id: str) -> None:
        self._peer_down_until[node_id] = (
            time.monotonic() + defaults.FEDERATION_PEER_BACKOFF_S)

    async def _fed_post(self, node_id: str, path: str, body: dict,
                        op: str) -> Optional[dict]:
        """One inter-node RPC: POST ``body`` (plus the current trace id,
        which the peer's _obs_middleware adopts — cross-node spans
        journal under the caller's id) to ``node_id``.  Failures mark
        the peer down for FEDERATION_PEER_BACKOFF_S and return None."""
        url = self.peers.get(node_id)
        if url is None or self._peer_down(node_id):
            return None
        body = dict(body, trace_id=obs_trace.current_trace_id())
        t0 = time.monotonic()
        try:
            async with self._fed_session().post(url + path,
                                                json=body) as resp:
                doc = await resp.json()
            if resp.status != 200:
                return None
            self._peer_down_until.pop(node_id, None)
            return doc
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            self._mark_peer_down(node_id)
            return None
        finally:
            _FED_RPC_SECONDS.observe(time.monotonic() - t0, op=op)

    async def _remote_steal(self, requester: bytes, want: int,
                            share_cap: Optional[int]):
        """The matchmaker's remote leg: walk the other nodes in
        ring-successor order (the federated continuation of the
        home-shard-last walk) and take the first served candidate.

        A full walk that comes back empty means the WHOLE federation is
        starved; retrying the ring on every subsequent fulfill would
        turn global starvation into an RPC storm that throttles local
        throughput (measured: ~4x on loopback).  An empty walk therefore
        arms a short negative cache and the remote leg sits out until it
        expires or a steal hits."""
        if self._steal_cooldown_until > time.monotonic():
            return None
        # arm BEFORE walking: concurrent fulfills that arrive while this
        # walk's RPCs are in flight skip instead of piling on; a hit
        # clears it again below
        self._steal_cooldown_until = (
            time.monotonic() + defaults.FEDERATION_STEAL_COOLDOWN_S)
        tried = 0
        for node in self.ring.steal_order(self.node_id):
            if node not in self.peers or self._peer_down(node):
                continue
            tried += 1
            doc = await self._fed_post(node, "/fed/steal", {
                "requester": bytes(requester).hex(),
                "want": int(want),
                "share_cap": share_cap,
            }, op="steal")
            if doc is None:
                _FED_STEALS.inc(outcome="error")
                continue
            if doc.get("candidate"):
                _FED_STEALS.inc(outcome="hit")
                self._steal_cooldown_until = 0.0
                return bytes.fromhex(doc["candidate"]), int(doc["match"])
        if tried:
            _FED_STEALS.inc(outcome="miss")
        return None

    async def _relay_notify(self, client_id: bytes,
                            msg: wire.JsonMessage) -> bool:
        """Forward a WS push to whichever node holds the client's
        socket: the ring owner first (where the client *should* be),
        then the rest — a failed-over client may be anywhere."""
        if self.ring is None:
            return False
        owner = self.ring.owner(client_id)
        order = [n for n in ([owner] + self.ring.steal_order(self.node_id))
                 if n is not None and n != self.node_id]
        seen = set()
        for node in order:
            if node in seen:
                continue
            seen.add(node)
            doc = await self._fed_post(node, "/fed/notify", {
                "client": bytes(client_id).hex(),
                "msg": msg.to_json(),
            }, op="notify")
            if doc is not None and doc.get("delivered"):
                _FED_NOTIFY_RELAYS.inc(outcome="delivered")
                return True
        _FED_NOTIFY_RELAYS.inc(outcome="failed")
        return False

    async def fed_steal(self, request):
        """Inter-node RPC: serve one matchmaking candidate to a remote
        requester (see ShardedMatchmaker.serve_steal for the
        invariants)."""
        if self.node_id is None or not isinstance(self.queue,
                                                  ShardedMatchmaker):
            raise self._err(wire.ErrorKind.BAD_REQUEST,
                            "federation not enabled")
        try:
            doc = json.loads(await request.text())
            requester = bytes.fromhex(doc["requester"])
            want = int(doc["want"])
            cap = doc.get("share_cap")
        except (ValueError, KeyError, TypeError) as e:
            raise self._err(wire.ErrorKind.BAD_REQUEST, str(e))
        served = await self.queue.serve_steal(
            requester, want, None if cap is None else int(cap))
        if served is None:
            _FED_STEAL_SERVED.inc(outcome="empty")
            return web.json_response({"candidate": None})
        _FED_STEAL_SERVED.inc(outcome="hit")
        return web.json_response({"candidate": served[0].hex(),
                                  "match": served[1]})

    async def fed_notify(self, request):
        """Inter-node RPC: deliver a WS push to a LOCALLY connected
        client (terminates here — never re-relays)."""
        if self.node_id is None:
            raise self._err(wire.ErrorKind.BAD_REQUEST,
                            "federation not enabled")
        try:
            doc = json.loads(await request.text())
            client = bytes.fromhex(doc["client"])
            msg = wire.JsonMessage.from_json(doc["msg"])
        except (ValueError, KeyError, TypeError) as e:
            raise self._err(wire.ErrorKind.BAD_REQUEST, str(e))
        delivered = await self.connections.notify_local(client, msg)
        return web.json_response({"delivered": delivered})

    def _maybe_redirect(self, pubkey: bytes, raw_body: str) -> None:
        """Wrong-node arrival on a session-less entry point: steer the
        client to its ring owner with a 421 NodeRedirect — unless the
        client pinned itself (``fed_pinned``, set after a failed dial or
        redirect hop: whatever node answers then keeps it) or the owner
        looks down.  Requests served in place remain CORRECT either way
        — the store routes by pubkey, not by serving node — so a stale
        client list costs latency, never a matchmaking."""
        if self.ring is None:
            return
        if isinstance(self.db, ReplicatedServerStore):
            # replication routes by partition OWNERSHIP (which promotion
            # moves), not raw ring position — redirect to wherever the
            # pubkey's partition currently lives.  Serving in place
            # stays correct: foreign-partition ops forward to the owner.
            owner = self.db.owners.get(self.db.partition_index(pubkey))
        else:
            owner = self.ring.owner(pubkey)
        if owner is None or owner == self.node_id:
            return
        url = self.peers.get(owner)
        if url is None or self._peer_down(owner):
            return
        try:
            if json.loads(raw_body).get("fed_pinned"):
                return
        except (ValueError, AttributeError):
            pass
        _RING_REDIRECTS.inc()
        raise web.HTTPMisdirectedRequest(
            text=wire.NodeRedirect(url=url).to_json(),
            content_type="application/json")

    # --- handlers (server/src/handlers/) -----------------------------------

    async def register_begin(self, request):
        msg = await self._parse(request, wire.ClientRegistrationRequest)
        self._maybe_redirect(msg.pubkey, await request.text())
        return self._ok(wire.ServerChallenge(
            nonce=self.auth.challenge_begin(msg.pubkey)))

    async def register_complete(self, request):
        msg = await self._parse(request, wire.ClientRegistrationAuth)
        nonce = self.auth.take_challenge(msg.pubkey)
        if nonce is None:
            # expired/unknown challenge: the client should restart the
            # flow (ChallengeNotFound -> Retry, handlers/mod.rs:73)
            raise self._err(wire.ErrorKind.RETRY)
        if not verify_signature(msg.pubkey, nonce, msg.challenge_response):
            raise self._err(wire.ErrorKind.BAD_REQUEST, "bad signature")
        if await self.db.aio.client_exists(msg.pubkey):
            # 409 CONFLICT with a BadRequest payload (ClientExists,
            # handlers/mod.rs:66,79)
            raise self._err(wire.ErrorKind.BAD_REQUEST,
                            "client already exists", status=409)
        await self.db.aio.register_client(msg.pubkey)
        return self._ok()

    async def login_begin(self, request):
        msg = await self._parse(request, wire.ClientLoginRequest)
        self._maybe_redirect(msg.pubkey, await request.text())
        if not await self.db.aio.client_exists(msg.pubkey):
            raise self._err(wire.ErrorKind.CLIENT_NOT_FOUND)
        return self._ok(wire.ServerChallenge(
            nonce=self.auth.challenge_begin(msg.pubkey)))

    async def login_complete(self, request):
        msg = await self._parse(request, wire.ClientLoginAuth)
        nonce = self.auth.take_challenge(msg.pubkey)
        if nonce is None:
            raise self._err(wire.ErrorKind.RETRY)
        if not verify_signature(msg.pubkey, nonce, msg.challenge_response):
            raise self._err(wire.ErrorKind.BAD_REQUEST, "bad signature")
        await self.db.aio.client_update_logged_in(msg.pubkey)
        return self._ok(wire.LoginToken(token=self.auth.session_start(msg.pubkey)))

    async def backup_request(self, request):
        msg = await self._parse(request, wire.BackupRequest)
        client = self._session(msg)
        try:
            await self.queue.fulfill(client, msg.storage_required,
                                     min_peers=msg.min_peers)
        except ValueError as e:
            raise self._err(wire.ErrorKind.BAD_REQUEST, str(e))
        return self._ok()

    async def backup_done(self, request):
        msg = await self._parse(request, wire.BackupDone)
        client = self._session(msg)
        await self.db.aio.save_snapshot(client, msg.snapshot_hash)
        return self._ok()

    async def backup_restore(self, request):
        msg = await self._parse(request, wire.BackupRestoreRequest)
        client = self._session(msg)
        snapshot = await self.db.aio.get_latest_client_snapshot(client)
        if snapshot is None:
            # NoBackupsAvailable -> 404 NoBackups (handlers/backup.rs:30-38)
            raise self._err(wire.ErrorKind.NO_BACKUPS)
        peers = await self.db.aio.get_client_negotiated_peers(client)
        # advertise the deployment's stripe geometry so a from-scratch
        # restore client knows how many peer streams can go dark before
        # coverage is actually at risk (the shard containers themselves
        # are self-describing; this is advisory)
        return self._ok(wire.BackupRestoreInfo(
            snapshot_hash=snapshot, peers=[p.hex() for p in peers],
            rs_k=defaults.RS_K, rs_m=defaults.RS_M))

    async def p2p_begin(self, request):
        msg = await self._parse(request, wire.BeginP2PConnectionRequest)
        client = self._session(msg)
        delivered = await self.connections.notify(
            msg.destination_client_id, wire.IncomingP2PConnection(
                source_client_id=client, session_nonce=msg.session_nonce))
        if not delivered:
            raise self._err(wire.ErrorKind.DESTINATION_UNREACHABLE)
        return self._ok()

    async def p2p_confirm(self, request):
        msg = await self._parse(request, wire.ConfirmP2PConnectionRequest)
        client = self._session(msg)
        delivered = await self.connections.notify(
            msg.source_client_id, wire.FinalizeP2PConnection(
                destination_client_id=client,
                destination_ip_address=msg.destination_ip_address))
        if not delivered:
            raise self._err(wire.ErrorKind.DESTINATION_UNREACHABLE)
        return self._ok()

    async def audit_report(self, request):
        """Record one client's audit verdict on a peer; on failure, nudge
        every other client storing on that peer to audit it soon (the
        server never sees data, only verdicts — SURVEY.md §1 holds)."""
        msg = await self._parse(request, wire.AuditReport)
        client = self._session(msg)
        peer = bytes(msg.peer_id)
        await self.db.aio.save_audit_report(client, peer, bool(msg.passed),
                                            msg.detail or "")
        if not msg.passed:
            for source in await self.db.aio.get_clients_storing_on(peer):
                if source not in (client, peer):
                    await self.connections.notify(
                        source, wire.AuditDue(peer_id=peer))
        return self._ok()

    async def repair_report(self, request):
        """Record a completed peer-loss repair and reclaim the negotiation
        edges between the reporter and the lost peer, so the reporter's
        restore peer list drops the dead peer immediately.  Only the
        reporter's own edges are touched — other clients keep their own
        view of the peer until their own audits/repairs decide."""
        msg = await self._parse(request, wire.RepairReport)
        client = self._session(msg)
        peer = bytes(msg.peer_id)
        if peer == client:
            raise self._err(wire.ErrorKind.BAD_REQUEST,
                            "cannot repair away from self")
        await self.db.aio.save_repair_report(client, peer, msg.packfiles_lost,
                                             msg.bytes_lost,
                                             msg.bytes_replaced)
        await self.db.aio.reclaim_negotiation(client, peer)
        return self._ok()

    # --- observability exposition (obs/expo.py) -----------------------------

    async def metrics(self, _request):
        self.queue.pending()  # refresh the queue-depth gauge
        _CONNECTED.set(self.connections.count())
        return obs_expo.metrics_response()

    async def healthz(self, _request):
        """Liveness plus the durability invariant summary.  The summary
        aggregates every InvariantMonitor publishing into this process's
        registry — all zeros / ``ok`` for a standalone server (the
        server never sees client placement state), and the live
        cross-client durability picture when clients are colocated (the
        scenario harness, tests, bench).  A violated invariant turns
        the whole document 503 (obs/expo.py)."""
        durability = obs_invariants.summary_from_registry()
        slo = obs_slo.summary_from_registry()
        return obs_expo.health_response(
            schema_version=await self.db.aio.schema_version(),
            queue_depth=self.queue.pending(),
            connected_clients=self.connections.count(),
            uptime_s=round(time.time() - self._started, 3),
            durability=durability,
            slo=slo,
            status=obs_slo.join_status(durability["status"],
                                       slo["status"]))

    async def ws(self, request):
        token = request.headers.get("Authorization")
        try:
            token_bytes = bytes.fromhex(token) if token else None
        except ValueError:
            raise self._err(wire.ErrorKind.UNAUTHORIZED, "malformed token")
        client = self.auth.get_session(token_bytes)
        if client is None:
            raise self._err(wire.ErrorKind.UNAUTHORIZED)
        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)
        self.connections.register(client, ws)
        try:
            async for msg in ws:
                if msg.type in (WSMsgType.ERROR, WSMsgType.CLOSE):
                    break
        finally:
            self.connections.unregister(client, ws)
        return ws

    # --- lifecycle ---------------------------------------------------------

    def app(self) -> web.Application:
        app = web.Application(client_max_size=1 << 20,
                              middlewares=[_obs_middleware])
        app.add_routes([
            web.get("/metrics", self.metrics),
            web.get("/healthz", self.healthz),
            web.post("/register/begin", self.register_begin),
            web.post("/register/complete", self.register_complete),
            web.post("/login/begin", self.login_begin),
            web.post("/login/complete", self.login_complete),
            web.post("/backups/request", self.backup_request),
            web.post("/backups/done", self.backup_done),
            web.post("/backups/restore", self.backup_restore),
            web.post("/p2p/connection/begin", self.p2p_begin),
            web.post("/p2p/connection/confirm", self.p2p_confirm),
            web.post("/audit/report", self.audit_report),
            web.post("/repair/report", self.repair_report),
            web.post("/fed/steal", self.fed_steal),
            web.post("/fed/notify", self.fed_notify),
            web.post("/repl/ship", self.repl_ship),
            web.post("/repl/promote", self.repl_promote),
            web.post("/repl/tail", self.repl_tail),
            web.post("/repl/forward", self.repl_forward),
            web.get("/ws", self.ws),
        ])
        app["bkw_server"] = self
        return app

    async def start(self, host="127.0.0.1", port=0,
                    ssl_context=None) -> int:
        """Serve; with ``ssl_context`` the control plane is HTTPS/WSS (the
        reference is TLS-by-default with a USE_TLS off-switch for local
        testing, requests.rs:246-258, docs/src/client.md:22)."""
        self._runner = web.AppRunner(self.app())
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port, ssl_context=ssl_context,
                           shutdown_timeout=defaults.SERVER_SHUTDOWN_GRACE_S)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except asyncio.CancelledError:
                pass
            self._probe_task = None
        if self._fed_http is not None:
            if not self._fed_http.closed:
                await self._fed_http.close()
            self._fed_http = None
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        # drain + retire the writer thread; the store stays readable
        # (tests inspect server.db after stop).  An injected store is
        # the caller's (a federated deployment shares it across node
        # instances — node kill/revive must not close siblings' store).
        if self._owns_store:
            self.db.close()
