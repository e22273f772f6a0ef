"""Web dashboard server: embedded SPA + WebSocket push/command channel.

Counterpart of ``backuwup_tpu/ui/server.py``, copied so that the port
imports nothing of the JAX package.

Re-designs the reference UI stack on aiohttp:

* ``ui/mod.rs:12-26`` — embedded static assets served at ``/``, push
  channel at ``/ws``;
* ``ui/ws.rs:31-56`` — per-client lag-tolerant forwarding of
  :class:`~backuwup_tpu_torch.ui.messenger.Messenger` events (bounded
  queues: a slow browser tab drops old frames, never blocks the engine);
* ``ui/ws_dispatcher.rs:16-23`` — the four UI commands (``config``,
  ``get_config``, ``start_backup``, ``start_restore``) dispatched onto the
  client app;
* ``ws_status_message.rs:128-163`` + ``backup/mod.rs:109-114`` — progress
  ticker (400 ms) and peer-list telemetry (250 ms) pushed at the cadences
  ``defaults.PROGRESS_TICKER_S`` / ``defaults.PEERS_DEBOUNCE_S`` while any
  client is connected.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Optional, Set

from aiohttp import WSMsgType, web

from .. import defaults
from .static import INDEX_HTML

_QUEUE_CAP = 1000  # per-client event buffer (client/src/main.rs:72)


def ui_bind_addr() -> str:
    return os.environ.get("UI_BIND_ADDR", "127.0.0.1:8102")


class UIServer:
    """Serves the dashboard for one
    :class:`~backuwup_tpu_torch.app.ClientApp`."""

    def __init__(self, client_app, bind: Optional[str] = None):
        self.app = client_app
        self.messenger = client_app.messenger
        host, _, port = (bind or ui_bind_addr()).rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self._web = web.Application()
        self._web.add_routes([web.get("/", self._index),
                              web.get("/ws", self._ws)])
        self._runner: Optional[web.AppRunner] = None
        self._clients: Set[asyncio.Queue] = set()
        self._unsubscribe = None
        self._ticker_task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    # --- lifecycle ---------------------------------------------------------

    async def start(self) -> str:
        self._loop = asyncio.get_running_loop()
        self._unsubscribe = self.messenger.subscribe(self._fanout)
        self._runner = web.AppRunner(self._web)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        # resolve the real port for ephemeral binds
        for s in site._server.sockets:
            self.port = s.getsockname()[1]
            break
        self._ticker_task = asyncio.create_task(self._ticker())
        return f"http://{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()
        if self._ticker_task is not None:
            self._ticker_task.cancel()
            try:
                await self._ticker_task
            except asyncio.CancelledError:
                pass
        if self._runner is not None:
            await self._runner.cleanup()

    # --- event fan-out (ui/ws.rs:31-56) ------------------------------------

    def _fanout(self, event) -> None:
        """Messenger callback; may fire from the packer thread."""
        if self._loop is None or not self._clients:
            return
        self._loop.call_soon_threadsafe(self._fanout_on_loop, event.to_json())

    def _fanout_on_loop(self, payload: str) -> None:
        for q in list(self._clients):
            if q.full():  # lag-tolerant: drop the oldest frame
                try:
                    q.get_nowait()
                except asyncio.QueueEmpty:
                    pass
            q.put_nowait(payload)

    async def _ticker(self) -> None:
        """Progress ticker + peer telemetry at the configured cadences."""
        last_peers = 0.0
        while True:
            await asyncio.sleep(defaults.PROGRESS_TICKER_S)
            if not self._clients:
                continue
            if self.messenger.progress_state.running:
                self.messenger.tick()
            now = asyncio.get_running_loop().time()
            if now - last_peers >= defaults.PEERS_DEBOUNCE_S:
                last_peers = now
                self.messenger.peers([
                    {"id": p.pubkey.hex(), "negotiated": p.bytes_negotiated,
                     "transmitted": p.bytes_transmitted,
                     "received": p.bytes_received,
                     "audit": self._peer_audit_health(p.pubkey)}
                    for p in self.app.store.list_peers()])

    def _peer_audit_health(self, pubkey: bytes) -> dict:
        st = self.app.store.get_audit_state(pubkey)
        if st.last_audit == 0.0 and not (st.passes or st.failures
                                         or st.misses):
            health = "unaudited"
        elif st.demoted:
            health = "demoted"
        else:
            health = st.last_result or "unaudited"
        return {"health": health, "passes": st.passes,
                "failures": st.failures, "misses": st.misses}

    # --- routes ------------------------------------------------------------

    async def _index(self, _request) -> web.Response:
        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def _ws(self, request) -> web.WebSocketResponse:
        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)
        queue: asyncio.Queue = asyncio.Queue(maxsize=_QUEUE_CAP)
        self._clients.add(queue)
        # late joiners see current state immediately
        self.messenger.tick()
        writer = asyncio.create_task(self._write_loop(ws, queue))
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    await self._dispatch(msg.data)
                elif msg.type == WSMsgType.ERROR:
                    break
        finally:
            self._clients.discard(queue)
            writer.cancel()
            try:
                await writer
            except asyncio.CancelledError:
                pass
        return ws

    async def _write_loop(self, ws, queue: asyncio.Queue) -> None:
        while True:
            payload = await queue.get()
            try:
                await ws.send_str(payload)
            except (ConnectionError, RuntimeError):
                return

    # --- command dispatcher (ui/ws_dispatcher.rs:16-66) --------------------

    async def _dispatch(self, raw: str) -> None:
        try:
            msg = json.loads(raw)
            command = msg.get("command")
        except (json.JSONDecodeError, AttributeError):
            self.messenger.error("malformed UI command")
            return
        if command == "get_config":
            self.messenger.config(
                {"backup_path": self.app.store.get_backup_path() or ""})
        elif command == "config":
            path = str(msg.get("backup_path", ""))
            self.app.store.set_backup_path(path)
            self.messenger.log(f"backup path set to {path}")
            self.messenger.config({"backup_path": path})
        elif command == "start_backup":
            asyncio.create_task(self._run_guarded(self.app.backup()))
        elif command == "start_restore":
            asyncio.create_task(self._run_guarded(self.app.restore()))
        elif command == "start_audit":
            asyncio.create_task(self._run_guarded(self.app.audit()))
        else:
            self.messenger.error(f"unknown UI command: {command!r}")

    async def _run_guarded(self, coro) -> None:
        try:
            await coro
        except Exception as e:  # surfaced to the dashboard, never raised
            self.messenger.error(str(e))
