"""Minimal ``websockets``-API shim over aiohttp (client + server).

Counterpart of ``backuwup_tpu/utils/ws_compat.py``, copied so that the
port imports nothing of the JAX package.

Containers that lack the ``websockets`` wheel always have aiohttp here
(the coordination server and UI are built on it), so the p2p layer gates:

    try:
        import websockets
    except ModuleNotFoundError:
        from ..utils import ws_compat as websockets

Only the surface :mod:`backuwup_tpu_torch.net.p2p` touches is provided:
``connect(url, max_size=)``, ``serve(handler, host, port, max_size=)``
(-> object with ``.sockets`` and a sync ``.close()``), connection objects
with ``send``/``recv``/``close``/async-iteration, and ``ConnectionClosed``.
"""

from __future__ import annotations

import asyncio
from typing import Optional

import aiohttp
from aiohttp import WSMsgType, web


class ConnectionClosed(Exception):
    """Raised by send/recv once the peer socket is gone."""


class _WS:
    """Wraps an aiohttp client or server websocket in websockets' API."""

    def __init__(self, ws, session: Optional[aiohttp.ClientSession] = None):
        self._ws = ws
        self._session = session

    async def send(self, data) -> None:
        try:
            await self._ws.send_bytes(bytes(data))
        except (ConnectionError, RuntimeError, aiohttp.ClientError) as e:
            raise ConnectionClosed(str(e)) from e

    async def recv(self):
        msg = await self._ws.receive()
        if msg.type == WSMsgType.BINARY:
            return msg.data
        if msg.type == WSMsgType.TEXT:
            return msg.data
        raise ConnectionClosed(f"websocket ended: {msg.type.name}")

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None

    async def close(self) -> None:
        try:
            await self._ws.close()
        except Exception:
            pass
        if self._session is not None:
            await self._session.close()
            self._session = None


async def connect(url: str, max_size: Optional[int] = None) -> _WS:
    session = aiohttp.ClientSession()
    try:
        ws = await session.ws_connect(
            url, max_msg_size=max_size or 4 * 2 ** 20, autoping=True)
    except aiohttp.ClientError as e:
        await session.close()
        # net/p2p dial-retry loops catch OSError, the type websockets raises
        raise OSError(f"websocket connect failed: {e}") from e
    except Exception:
        await session.close()
        raise
    return _WS(ws, session)


class _Server:
    """Mirrors websockets' server handle: .sockets + sync .close()."""

    def __init__(self, runner: web.ServerRunner, site: web.TCPSite):
        self._runner = runner
        self._site = site

    @property
    def sockets(self):
        return self._site._server.sockets

    def close(self) -> None:
        self._site._server.close()
        # cleanup() is async; websockets' close() is sync — detach it.
        loop = asyncio.get_event_loop()
        if loop.is_running():
            loop.create_task(self._runner.cleanup())


async def serve(handler, host: str, port: int,
                max_size: Optional[int] = None) -> _Server:
    async def http_handler(request: web.BaseRequest):
        ws = web.WebSocketResponse(max_msg_size=max_size or 4 * 2 ** 20)
        await ws.prepare(request)
        await handler(_WS(ws))
        return ws

    runner = web.ServerRunner(web.Server(http_handler))
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    return _Server(runner, site)
