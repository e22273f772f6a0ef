"""Executable entry points: ``python -m backuwup_tpu_torch client|server``.

Counterpart of ``backuwup_tpu/__main__.py``, copied so that the port
imports nothing of the JAX package.  Its block that pins the JAX platform
is gone; in its place the ``client`` role takes ``--device {cuda,cpu}``:
``cuda`` (the default) runs the engine on the card and exits non-zero
when CUDA is missing, ``cpu`` runs the kernels' plain versions on the
CPU (``GpuBackend(device="cpu")``).  The ``server`` role runs no kernel.

The client main mirrors ``client/src/main.rs:44-85``: boot config store ->
key manager (first-run guide / restore-from-phrase) -> panic hook -> UI
messenger -> P2P handlers -> long-lived server-WS + UI dashboard tasks.
The server main mirrors ``server/src/main.rs:40-65``: database + the
singletons behind an HTTP+WS router.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys
from pathlib import Path
from typing import Optional


def _addr_host(addr: str) -> str:
    """Host part of a ``host:port`` address, handling bracketed IPv6
    literals like ``[::1]:8080`` and bare ``::1``."""
    from urllib.parse import urlsplit
    try:
        host = urlsplit(f"//{addr}").hostname
        if host:
            return host
    except ValueError:
        pass
    return addr  # bare IPv6 like ::1, or something urlsplit rejects


def _install_excepthook(messenger) -> None:
    """Panic hook (client/src/main.rs:53-61): report to the UI channel,
    then exit nonzero."""
    previous = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            messenger.panic(f"{exc_type.__name__}: {exc}")
        finally:
            previous(exc_type, exc, tb)
            sys.exit(70)

    sys.excepthook = hook


async def _run_client(args) -> int:
    from .app import ClientApp
    from .ui import cli as ui_cli
    from .ui.messenger import Messenger
    from .ui.server import UIServer
    from .store import Store

    # the card unless the CPU is asked for: never a silent fallback
    backend = None  # ClientApp takes select_backend(): the card
    if args.device == "cpu":
        from .ops.backend import GpuBackend
        backend = GpuBackend(device="cpu")
    else:
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device: the client runs on the card; pass "
                  "--device cpu to run it on the CPU", file=sys.stderr)
            return 2

    messenger = Messenger()
    _install_excepthook(messenger)
    messenger.subscribe(lambda ev: print(
        f"[{ev.kind}] {ev.payload.get('text', '')}".rstrip(), flush=True)
        if ev.kind in ("message", "panic", "error") else None)

    # first-run guide: fresh identity or restore-from-phrase (cli.rs:10-23)
    root_secret: Optional[bytes] = None
    probe = Store(args.config_dir and Path(args.config_dir))
    has_identity = probe.get_root_secret() is not None
    probe.close()
    if not has_identity:
        if args.restore_phrase:
            from .crypto import parse_recovery
            try:
                root_secret = parse_recovery(args.restore_phrase)
            except ValueError as e:
                print(f"invalid --restore-phrase: {e}", file=sys.stderr)
                return 2
        elif sys.stdin.isatty() and not args.non_interactive:
            root_secret = ui_cli.first_run_guide()

    # TLS is on by default (reference posture); a loopback server with no
    # explicit USE_TLS / CA configured is the local-testing case
    # (docs/src/client.md:22) — default it to plaintext so the
    # out-of-the-box `server` + `client` pairing connects.  The decision
    # is passed explicitly to ClientApp (never by mutating os.environ,
    # which would leak into every ServerClient in the process).
    addr = args.server_addr or os.environ.get("SERVER_ADDR",
                                              "127.0.0.1:8080")
    tls: Optional[bool] = None
    if args.no_tls:
        tls = False
    elif "USE_TLS" not in os.environ and "TLS_CA_FILE" not in os.environ \
            and _addr_host(addr) in ("127.0.0.1", "localhost", "::1"):
        print("note: loopback server and no TLS config; using plaintext "
              "(set USE_TLS=1 or TLS_CA_FILE to force TLS)", flush=True)
        tls = False

    app = ClientApp(
        config_dir=args.config_dir and Path(args.config_dir),
        data_dir=args.data_dir and Path(args.data_dir),
        server_addr=args.server_addr,
        backend=backend,
        messenger=messenger,
        root_secret=root_secret,
        tls=tls)
    if app.fresh_identity and root_secret is None:
        ui_cli.print_recovery_phrase(app.keys.root_secret)
    if args.backup_path:
        app.store.set_backup_path(args.backup_path)

    await app.start()
    ui = UIServer(app, bind=args.ui_bind)
    url = await ui.start()
    messenger.log(f"dashboard at {url}")

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    messenger.log("shutting down")
    await ui.stop()
    await app.stop()
    return 0


async def _run_server(args) -> int:
    from .net.server import CoordinationServer

    server = CoordinationServer(db_path=args.db)
    host, _, port = args.bind.rpartition(":")
    host = host or "127.0.0.1"
    ssl_context = None
    cert = os.environ.get("TLS_CERT_FILE")
    key = os.environ.get("TLS_KEY_FILE")
    if cert and key:
        import ssl
        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(cert, key)
    port = await server.start(host, int(port), ssl_context=ssl_context)
    scheme = "https" if ssl_context else "http"
    print(f"coordination server listening on {host}:{port} ({scheme})",
          flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    await server.stop()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="backuwup_tpu_torch",
        description="peer-to-peer encrypted backup (GPU-accelerated dedup)")
    sub = parser.add_subparsers(dest="role", required=True)

    c = sub.add_parser("client", help="run the backup client + dashboard")
    c.add_argument("--config-dir", help="state directory (CONFIG_DIR env)")
    c.add_argument("--data-dir", help="data directory (DATA_DIR env)")
    c.add_argument("--server-addr", help="coordination server URL "
                                         "(SERVER_ADDR env)")
    c.add_argument("--ui-bind", help="dashboard bind, host:port "
                                     "(UI_BIND_ADDR env, default "
                                     "127.0.0.1:8102)")
    c.add_argument("--backup-path", help="directory to back up")
    c.add_argument("--restore-phrase",
                   help="recover an identity from this phrase — 24-word "
                        "mnemonic or base32 code (first run)")
    c.add_argument("--non-interactive", action="store_true",
                   help="never prompt; generate a fresh identity if none")
    c.add_argument("--no-tls", action="store_true",
                   help="plaintext control plane (USE_TLS=0)")
    c.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the engine runs: the card (default; exits "
                        "if CUDA is missing) or the CPU")

    s = sub.add_parser("server", help="run the coordination server")
    s.add_argument("--bind", default="127.0.0.1:8100",
                   help="listen address, host:port")
    s.add_argument("--db", default="backuwup_server.sqlite3",
                   help="SQLite database path")

    args = parser.parse_args(argv)
    runner = _run_client if args.role == "client" else _run_server
    try:
        return asyncio.run(runner(args))
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
