"""Client control plane: typed server RPCs + persistent push channel.

Counterpart of ``backuwup_tpu/net/client.py``, copied so that the port
imports nothing of the JAX package. What it sends is the reference's, byte
for byte, so it talks to either package's server.

Re-designs ``client/src/net_server/`` (requests.rs + mod.rs): every call is
a typed JSON POST; authentication failures trigger one transparent re-login
(``retry_with_login``, requests.rs:212-235); a persistent WebSocket carries
server push messages (BackupMatched / IncomingP2PConnection /
FinalizeP2PConnection / Ping) with an infinite reconnect loop
(``net_server/mod.rs:26-55``).

Server address resolution honors the ``SERVER_ADDR`` env seam the reference
uses for testing (requests.rs:246-258).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Callable, Optional

import aiohttp

from .. import defaults, wire
from ..crypto import KeyManager
from ..obs import trace as obs_trace
from ..store import Store
from ..utils import retry


class ServerError(Exception):
    """Base of the typed error taxonomy (wire.ErrorKind; the reference
    client pattern-matches the 8 ErrorType variants,
    server_message.rs:43-54)."""

    KIND = wire.ErrorKind.FAILURE

    def __init__(self, detail: str = "", kind: str = None):
        self.kind = kind or self.KIND
        self.detail = detail
        super().__init__(f"{self.kind}: {detail}" if detail else self.kind)


class Unauthorized(ServerError):
    KIND = wire.ErrorKind.UNAUTHORIZED


class ClientNotFound(ServerError):
    KIND = wire.ErrorKind.CLIENT_NOT_FOUND


class DestinationUnreachable(ServerError):
    KIND = wire.ErrorKind.DESTINATION_UNREACHABLE


class NoBackups(ServerError):
    KIND = wire.ErrorKind.NO_BACKUPS


class RetryLater(ServerError):
    KIND = wire.ErrorKind.RETRY


class BadRequest(ServerError):
    KIND = wire.ErrorKind.BAD_REQUEST


class ClientExists(BadRequest):
    """409-status BadRequest: the identity is already registered (the
    restore-from-phrase path hits this and proceeds to login)."""


class ServerFault(ServerError):
    KIND = wire.ErrorKind.SERVER_ERROR


_KIND_TO_EXC = {
    wire.ErrorKind.UNAUTHORIZED: Unauthorized,
    wire.ErrorKind.CLIENT_NOT_FOUND: ClientNotFound,
    wire.ErrorKind.DESTINATION_UNREACHABLE: DestinationUnreachable,
    wire.ErrorKind.NO_BACKUPS: NoBackups,
    wire.ErrorKind.RETRY: RetryLater,
    wire.ErrorKind.BAD_REQUEST: BadRequest,
    wire.ErrorKind.SERVER_ERROR: ServerFault,
    wire.ErrorKind.FAILURE: ServerError,
}


def server_addr() -> str:
    return os.environ.get("SERVER_ADDR", "127.0.0.1:8080")


def use_tls() -> bool:
    """TLS-by-default with a USE_TLS=0 off-switch for local testing,
    mirroring client/src/defaults.rs:6-7 + requests.rs:246-258."""
    return os.environ.get("USE_TLS", "1") not in ("0", "false", "no")


def _ssl_client_context():
    """Client-side SSL context; TLS_CA_FILE pins a (self-signed) CA."""
    import ssl

    ca = os.environ.get("TLS_CA_FILE")
    if ca:
        return ssl.create_default_context(cafile=ca)
    return ssl.create_default_context()


class ServerClient:
    """One client's control-plane connection to the coordination server.

    ``addr`` accepts a single ``host:port`` or a LIST of them (a
    federated deployment, docs/server.md §Federation — order them owner
    node first).  Failover rules, chosen so a request is never submitted
    twice:

    * only a DIAL-level failure (``aiohttp.ClientConnectorError`` — the
      request never reached any server) rotates to the next URL and
      retries; once any response arrives, the outcome is final for that
      call (a timeout or dropped response might have been processed);
    * a 421 :class:`wire.NodeRedirect` is followed at most once per
      call, and only toward a URL already on the configured list;
    * after a refused dial or a failed redirect hop the client pins
      itself (``fed_pinned`` rides in the POST body) for
      ``FEDERATION_CLIENT_PIN_S`` so servers stop redirecting it while
      its view of the ring is demonstrably stale — no ping-pong.
    """

    def __init__(self, keys: KeyManager, store: Store,
                 addr=None, tls: Optional[bool] = None):
        self.keys = keys
        self.store = store
        if addr is None:
            addr = server_addr()
        self.addrs = ([str(a) for a in addr]
                      if isinstance(addr, (list, tuple)) else [str(addr)])
        self._addr_i = 0
        self.failovers = 0  # dial-level URL rotations (test/scorecard hook)
        self._pinned_until = 0.0
        self.tls = use_tls() if tls is None else tls
        self._http: Optional[aiohttp.ClientSession] = None
        self._ws_task: Optional[asyncio.Task] = None
        # push-handler tasks (backup-matched / p2p rendezvous); cancelled
        # on close so none outlive the event loop (teardown hygiene)
        self._handler_tasks: set = set()
        self.on_backup_matched: Optional[Callable] = None
        self.on_incoming_p2p: Optional[Callable] = None
        self.on_finalize_p2p: Optional[Callable] = None
        self.on_audit_due: Optional[Callable] = None
        self.ws_connected = asyncio.Event()

    # --- federated address book --------------------------------------------

    @property
    def addr(self) -> str:
        return self.addrs[self._addr_i]

    @property
    def base(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.addr}"

    def _rotate(self) -> None:
        """Dial failed: pin + advance to the next configured node."""
        self.failovers += 1
        self._pinned_until = (asyncio.get_event_loop().time()
                              + defaults.FEDERATION_CLIENT_PIN_S)
        self._addr_i = (self._addr_i + 1) % len(self.addrs)

    def _pinned(self) -> bool:
        return asyncio.get_event_loop().time() < self._pinned_until

    def _take_redirect(self, url: str) -> bool:
        """Follow a NodeRedirect only toward a URL already on the
        configured list (and not the one we are already using)."""
        scheme = "https" if self.tls else "http"
        target = url.rstrip("/")
        for i, a in enumerate(self.addrs):
            if f"{scheme}://{a}" == target and i != self._addr_i:
                self._addr_i = i
                return True
        return False

    async def _session(self) -> aiohttp.ClientSession:
        if self._http is None or self._http.closed:
            if self.tls:
                connector = aiohttp.TCPConnector(ssl=_ssl_client_context())
                self._http = aiohttp.ClientSession(connector=connector)
            else:
                self._http = aiohttp.ClientSession()
        return self._http

    async def close(self) -> None:
        if self._ws_task is not None:
            self._ws_task.cancel()
            try:
                await self._ws_task
            except (asyncio.CancelledError, Exception):
                pass
            self._ws_task = None
        for t in list(self._handler_tasks):
            t.cancel()
        if self._handler_tasks:
            await asyncio.gather(*self._handler_tasks,
                                 return_exceptions=True)
            self._handler_tasks.clear()
        if self._http is not None and not self._http.closed:
            await self._http.close()

    def _spawn_handler(self, coro) -> None:
        task = asyncio.create_task(coro)
        self._handler_tasks.add(task)
        task.add_done_callback(self._handler_tasks.discard)

    # --- raw RPC -----------------------------------------------------------

    async def _post(self, path: str, msg: wire.JsonMessage) -> wire.JsonMessage:
        with obs_trace.span(f"client{path}"):
            return await self._post_traced(path, msg)

    def _payload(self, msg: wire.JsonMessage) -> str:
        doc = json.loads(msg.to_json())
        tid = obs_trace.current_trace_id()
        if tid:
            # extra JSON keys: from_json ignores unknown keys, so old
            # servers interoperate; new ones join the trace (obs/trace.py)
            doc["trace_id"] = tid
        if self._pinned():
            doc["fed_pinned"] = True
        return json.dumps(doc, separators=(",", ":"), sort_keys=True)

    async def _post_traced(self, path: str,
                           msg: wire.JsonMessage) -> wire.JsonMessage:
        http = await self._session()
        # dial failures may try every configured node once; any received
        # response is final (see the class docstring's no-double-submit
        # rule).  Single-address clients keep the pre-federation shape:
        # one attempt, the connect error propagates.
        dials_left = len(self.addrs) if len(self.addrs) > 1 else 1
        redirected = False
        while True:
            try:
                async with http.post(self.base + path,
                                     data=self._payload(msg)) as resp:
                    body = await resp.text()
                    status = resp.status
            except aiohttp.ClientConnectorError:
                dials_left -= 1
                if dials_left <= 0:
                    raise
                self._rotate()
                continue
            try:
                out = wire.JsonMessage.from_json(body)
            except ValueError:
                out = wire.Error(kind=wire.ErrorKind.FAILURE,
                                 detail=f"unparseable response: {body[:200]}")
            if status == 421 and isinstance(out, wire.NodeRedirect):
                if not redirected and self._take_redirect(out.url):
                    redirected = True
                    continue
                raise RetryLater(f"misdirected request: {out.url}")
            if status >= 400 or isinstance(out, wire.Error):
                kind = getattr(out, "kind", wire.ErrorKind.FAILURE)
                detail = getattr(out, "detail", "")
                if status == 409 and kind == wire.ErrorKind.BAD_REQUEST:
                    raise ClientExists(detail)
                exc = _KIND_TO_EXC.get(kind, ServerError)
                raise exc(detail)
            return out

    # --- identity flows (identity.rs) --------------------------------------

    async def register(self) -> None:
        challenge = await self._post("/register/begin",
                                     wire.ClientRegistrationRequest(
                                         pubkey=self.keys.client_id))
        try:
            await self._post("/register/complete",
                             wire.ClientRegistrationAuth(
                                 pubkey=self.keys.client_id,
                                 challenge_response=self.keys.sign(
                                     challenge.nonce)))
        except ClientExists:
            # a recovered identity (restore-from-phrase) is already
            # registered; proceed to login (identity.rs:46-69)
            pass

    async def login(self) -> bytes:
        challenge = await self._post("/login/begin", wire.ClientLoginRequest(
            pubkey=self.keys.client_id))
        out = await self._post("/login/complete", wire.ClientLoginAuth(
            pubkey=self.keys.client_id,
            challenge_response=self.keys.sign(challenge.nonce)))
        self.store.set_auth_token(out.token)
        return out.token

    async def _token(self) -> bytes:
        token = self.store.get_auth_token()
        if token is None:
            token = await self.login()
        return token

    async def _with_login(self, call):
        """Re-auth once on 401 (requests.rs:212-235)."""
        try:
            return await call(await self._token())
        except Unauthorized:
            self.store.set_auth_token(None)
            return await call(await self.login())

    # --- typed API (requests.rs) -------------------------------------------

    async def backup_storage_request(self, storage_required: int,
                                     min_peers: int = 1) -> None:
        """``min_peers > 1`` asks the matchmaker to spread the grant over
        that many distinct candidates (erasure stripes need k+m holders)."""
        await self._with_login(lambda t: self._post(
            "/backups/request",
            wire.BackupRequest(session_token=t,
                               storage_required=storage_required,
                               min_peers=min_peers)))

    async def backup_done(self, snapshot_hash: bytes) -> None:
        await self._with_login(lambda t: self._post(
            "/backups/done",
            wire.BackupDone(session_token=t, snapshot_hash=snapshot_hash)))

    async def backup_restore(self) -> wire.BackupRestoreInfo:
        return await self._with_login(lambda t: self._post(
            "/backups/restore", wire.BackupRestoreRequest(session_token=t)))

    async def p2p_connection_begin(self, destination: bytes,
                                   session_nonce: bytes) -> None:
        await self._with_login(lambda t: self._post(
            "/p2p/connection/begin", wire.BeginP2PConnectionRequest(
                session_token=t, destination_client_id=destination,
                session_nonce=session_nonce)))

    async def p2p_connection_confirm(self, source: bytes, addr: str) -> None:
        await self._with_login(lambda t: self._post(
            "/p2p/connection/confirm", wire.ConfirmP2PConnectionRequest(
                session_token=t, source_client_id=source,
                destination_ip_address=addr)))

    async def audit_report(self, peer_id: bytes, passed: bool,
                           detail: str = "") -> None:
        await self._with_login(lambda t: self._post(
            "/audit/report", wire.AuditReport(
                session_token=t, peer_id=bytes(peer_id), passed=passed,
                detail=detail)))

    async def repair_report(self, peer_id: bytes, packfiles_lost: int,
                            bytes_lost: int, bytes_replaced: int) -> None:
        await self._with_login(lambda t: self._post(
            "/repair/report", wire.RepairReport(
                session_token=t, peer_id=bytes(peer_id),
                packfiles_lost=int(packfiles_lost),
                bytes_lost=int(bytes_lost),
                bytes_replaced=int(bytes_replaced))))

    # --- push channel (net_server/mod.rs) ----------------------------------

    def start_ws(self) -> asyncio.Task:
        if self._ws_task is None or self._ws_task.done():
            self._ws_task = asyncio.create_task(self._ws_loop())
        return self._ws_task

    async def _ws_loop(self) -> None:
        backoff = retry.Backoff(retry.WS_RECONNECT)
        while True:
            try:
                token = await self._token()
                http = await self._session()
                async with http.ws_connect(
                        self.base + "/ws",
                        headers={"Authorization": bytes(token).hex()}) as ws:
                    self.ws_connected.set()
                    # an accepted connection ends the outage: the next
                    # failure backs off from the base delay again
                    backoff.reset()
                    async for msg in ws:
                        if msg.type != aiohttp.WSMsgType.TEXT:
                            break
                        await self._dispatch(msg.data)
            except Unauthorized:
                self.store.set_auth_token(None)
            except asyncio.CancelledError:
                raise
            except aiohttp.ClientConnectorError as e:
                # refused dial: this node is down — rotate to the next
                # configured node before backing off
                if len(self.addrs) > 1:
                    self._rotate()
                logging.getLogger(__name__).debug(
                    "server WS dial failed: %s; rotating + reconnecting", e)
            except aiohttp.WSServerHandshakeError as e:
                # session tokens are node-local: after a failover the
                # next node rejects the stale token — drop it so the
                # retry re-logs-in there
                if e.status == 401:
                    self.store.set_auth_token(None)
                logging.getLogger(__name__).debug(
                    "server WS handshake failed: %s; reconnecting", e)
            except (aiohttp.ClientError, ServerError, OSError,
                    RuntimeError) as e:
                # reconnect loop (net_server/mod.rs:26-55): log, back off,
                # retry — but never swallow unrelated programming errors
                logging.getLogger(__name__).debug(
                    "server WS dropped: %s; reconnecting", e)
            self.ws_connected.clear()
            # unified jittered backoff (utils/retry.py), unbounded: the
            # push channel must always come back eventually
            await backoff.sleep()

    async def _dispatch(self, raw: str) -> None:
        try:
            msg = wire.JsonMessage.from_json(raw)
        except ValueError:
            return
        # each push handled in its own task (net_server/mod.rs:58-90)
        if isinstance(msg, wire.BackupMatched) and self.on_backup_matched:
            self._spawn_handler(self.on_backup_matched(msg))
        elif isinstance(msg, wire.IncomingP2PConnection) and self.on_incoming_p2p:
            self._spawn_handler(self.on_incoming_p2p(msg))
        elif isinstance(msg, wire.FinalizeP2PConnection) and self.on_finalize_p2p:
            self._spawn_handler(self.on_finalize_p2p(msg))
        elif isinstance(msg, wire.AuditDue) and self.on_audit_due:
            self._spawn_handler(self.on_audit_due(msg))
