"""Metrics exposition: ``GET /metrics`` + ``GET /healthz`` plumbing.

Counterpart of ``backuwup_tpu/obs/expo.py``, copied so that the port
imports nothing of the JAX package.

Two consumers share these helpers:

* the coordination server (net/server.py) mounts the handlers directly
  on its existing aiohttp application;
* :class:`StatusServer` is a tiny standalone site for the opt-in client
  status port (``ClientApp(status_port=...)`` / ``BKW_STATUS_PORT``),
  so a headless client can be scraped without running the dashboard.

Deliberately NOT imported by ``obs/__init__`` — the obs core stays
stdlib-only, and aiohttp loads only where something actually serves.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from aiohttp import web

from . import metrics as _metrics

#: Prometheus text exposition content type (version 0.0.4).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def metrics_response() -> web.Response:
    """The registry rendered as Prometheus text exposition."""
    body = _metrics.registry().render_prometheus()
    resp = web.Response(text=body)
    resp.headers["Content-Type"] = CONTENT_TYPE
    return resp


def health_response(**fields) -> web.Response:
    """``{"status": "ok", ...fields}`` as JSON (liveness plus whatever
    cheap facts the mounting process wants to advertise).  A caller
    that passes ``status="violated"`` — a broken durability invariant
    (obs/invariants.py) — gets HTTP 503 so dumb probes flip without
    parsing the body; ``degraded`` stays 200 (data still restorable,
    margin shrinking)."""
    doc = {"status": "ok", **fields}
    code = 503 if doc.get("status") == "violated" else 200
    return web.json_response(doc, status=code)


class StatusServer:
    """Opt-in client status port: ``/metrics`` + ``/healthz`` only.

    ``health_fn`` (optional, zero-arg) returns extra fields merged into
    the /healthz document; ``before_metrics`` (optional, zero-arg) runs
    before each render so the owner can refresh point-in-time gauges.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 health_fn: Optional[Callable[[], dict]] = None,
                 before_metrics: Optional[Callable[[], None]] = None):
        self.host = host
        self.port = port
        self.health_fn = health_fn
        self.before_metrics = before_metrics
        self._runner: Optional[web.AppRunner] = None
        self._started = time.time()

    async def _metrics(self, _request) -> web.Response:
        if self.before_metrics is not None:
            self.before_metrics()
        return metrics_response()

    async def _healthz(self, _request) -> web.Response:
        fields = {"uptime_s": round(time.time() - self._started, 3)}
        if self.health_fn is not None:
            fields.update(self.health_fn())
        return health_response(**fields)

    async def start(self) -> int:
        self._started = time.time()
        app = web.Application()
        app.add_routes([web.get("/metrics", self._metrics),
                        web.get("/healthz", self._healthz)])
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
