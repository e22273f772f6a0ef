"""Client application: wires identity, store, networking, and engine.

Counterpart of ``backuwup_tpu/app.py``, copied so that the port
imports nothing of the JAX package.  One change: ``ClientApp`` takes
``dedup_device`` where the reference takes ``dedup_mesh``, as the port's
:class:`~backuwup_tpu_torch.engine.Engine` does.  With ``backend=None``
the engine takes ``select_backend()``, the card (it raises without
CUDA); ``GpuBackend(device="cpu")`` runs the plain versions.

The equivalent of the reference client's ``main()`` boot sequence
(``client/src/main.rs:44-85``): load-or-create identity, register/login,
start the push channel, install the P2P request handlers (store incoming
peer data; serve restores), and expose backup/restore entry points.
"""

from __future__ import annotations

import asyncio
import os
from pathlib import Path
from typing import Optional

from . import wire
from .crypto import KeyManager
from .engine import Engine
from .net.client import ServerClient
from .net.p2p import P2PNode, ReceivedFilesWriter, Receiver
from .obs import diagnose as obs_diagnose
from .obs import slo as obs_slo
from .obs.invariants import InvariantMonitor
from .obs.series import SeriesRecorder
from .ops.backend import ChunkerBackend
from .store import Store
from .ui.messenger import Messenger


class ClientApp:
    def __init__(self, config_dir: Optional[Path] = None,
                 data_dir: Optional[Path] = None,
                 server_addr: Optional[str] = None,
                 backend: Optional[ChunkerBackend] = None,
                 messenger: Optional[Messenger] = None,
                 dedup_device=None,
                 root_secret: Optional[bytes] = None,
                 tls: Optional[bool] = None,
                 status_port: Optional[int] = None):
        """``root_secret`` injects a recovered identity (the
        restore-from-phrase flow, ``identity.rs:46-69``): the secret is
        persisted and all keys re-derive deterministically, so a disaster
        recovery proceeds as this identity.  Raises if the store already
        holds a *different* identity.

        ``status_port`` (or ``BKW_STATUS_PORT``) opts the client into a
        loopback /metrics + /healthz listener; port 0 picks an ephemeral
        port, exposed as :attr:`status_port` after :meth:`start`."""
        self.store = Store(config_dir, data_base=data_dir)
        self.messenger = messenger or Messenger()
        secret = self.store.get_root_secret()
        if root_secret is not None:
            if secret is not None and secret != root_secret:
                self.store.close()
                raise ValueError(
                    "store already holds a different identity; refusing to "
                    "overwrite it with the recovered secret")
            self.keys = KeyManager.from_secret(root_secret)
            if secret is None:
                self.store.set_root_secret(root_secret)
            self.fresh_identity = secret is None
        elif secret is None:
            self.keys = KeyManager.generate()
            self.store.set_root_secret(self.keys.root_secret)
            self.store.set_obfuscation_key(os.urandom(4))
            self.fresh_identity = True
        else:
            self.keys = KeyManager.from_secret(secret)
            self.fresh_identity = False
        if self.store.get_obfuscation_key() is None:
            self.store.set_obfuscation_key(os.urandom(4))
        self.server = ServerClient(self.keys, self.store, addr=server_addr,
                                   tls=tls)
        self.node = P2PNode(self.keys, self.store, self.server)
        self.node.on_transport_request = self._accept_peer_data
        self.node.on_restore_request = self._serve_restore
        self.node.on_restore_fetch_request = self._serve_restore_fetch
        self.node.on_reclaim_request = self._serve_reclaim
        self.node.on_audit_request = self._serve_audit
        self.server.on_backup_matched = self._backup_matched
        self.server.on_audit_due = self._audit_due
        self.engine = Engine(self.keys, self.store, self.server, self.node,
                             backend=backend, messenger=self.messenger,
                             dedup_device=dedup_device)
        self.monitor = InvariantMonitor(self.store, index=self.engine.index,
                                        client=self.client_id.hex()[:8])
        # live SLO plane: ring-buffer history over the catalog's families
        # plus the durability scoreboard, burn-rate evaluation riding the
        # same cadence, diagnosis on breach (docs/observability.md §SLOs)
        slo_catalog = obs_slo.parse_catalog()
        families = sorted({o.family for o in slo_catalog}
                          | {o.total_family for o in slo_catalog
                             if o.total_family}
                          | {"bkw_durability_status",
                             "bkw_durability_repair_debt_bytes"})
        self.series = SeriesRecorder(families)
        self.slo = obs_slo.SLOMonitor(
            self.series, catalog=slo_catalog,
            on_breach=lambda breach: obs_diagnose.explain(
                breach, recorder=self.series),
            client=self.client_id.hex()[:8])
        self._audit_task: Optional[asyncio.Task] = None
        self._monitor_task: Optional[asyncio.Task] = None
        self._slo_task: Optional[asyncio.Task] = None
        if status_port is None:
            env_port = os.environ.get("BKW_STATUS_PORT", "")
            status_port = int(env_port) if env_port else None
        self._status_port_req = status_port
        self._status_server = None
        self.status_port: Optional[int] = None

    @classmethod
    def from_phrase(cls, phrase: str, **kwargs) -> "ClientApp":
        """Rebuild an identity from its recovery phrase — word or base32
        form (cli.rs:26-51)."""
        from .crypto import parse_recovery
        return cls(root_secret=parse_recovery(phrase), **kwargs)

    @property
    def client_id(self) -> bytes:
        return self.keys.client_id

    # --- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Register (first run) / login, then open the push channel."""
        if not self.store.is_initialized():
            await self.server.register()
            self.store.set_initialized()
        await self.server.login()
        self.server.start_ws()
        await asyncio.wait_for(self.server.ws_connected.wait(), 10)
        # reconcile disk against the config DB before ANY scheduler runs:
        # a previous process may have died mid-commit, and the schedulers
        # must start from a consistent world (docs/crash_consistency.md)
        recovery = await self.engine.recover()
        self.messenger.log(
            f"recovery: reconciled {recovery['reconciled']} item(s),"
            f" backlog packfiles={recovery['packfiles_pending']}"
            f" stripes={recovery['stripes_underplaced']}"
            f" in {recovery['elapsed_s']:.3f}s")
        self._audit_task = asyncio.create_task(
            self.engine.audit_scheduler())
        self._monitor_task = asyncio.create_task(
            # the durability sweep doubles as the receiver-side TTL
            # janitor's clock, so abandoned partials age out without a
            # restart (engine.expire_partials also runs in recovery)
            self.monitor.run(janitor=self.engine.expire_partials))
        self._slo_task = asyncio.create_task(
            # series sampling and burn-rate evaluation ride one cadence so
            # every evaluation judges a freshly appended point
            self.series.run(on_sample=self.slo.evaluate))
        if self._status_port_req is not None:
            from .obs.expo import StatusServer
            self._status_server = StatusServer(
                port=self._status_port_req,
                health_fn=lambda: {
                    "client_id": self.client_id.hex(),
                    "busy": self.engine._exclusive.locked(),
                    # sweep on demand: health is never staler than the ask
                    "durability": self.monitor.sweep().summary,
                    "slo": self.slo.summary(),
                    "status": obs_slo.join_status(
                        self.monitor.last_report.status,
                        self.slo.summary()["status"])},
                before_metrics=lambda: self.monitor.sweep())
            self.status_port = await self._status_server.start()
            self.messenger.log(
                f"status listener on 127.0.0.1:{self.status_port}")
        self.messenger.log("connected to coordination server")

    async def stop(self) -> None:
        if self._status_server is not None:
            await self._status_server.stop()
            self._status_server = None
            self.status_port = None
        if self._audit_task is not None:
            self._audit_task.cancel()
            try:
                await self._audit_task
            except (asyncio.CancelledError, Exception):
                pass
            self._audit_task = None
        if self._monitor_task is not None:
            self._monitor_task.cancel()
            try:
                await self._monitor_task
            except (asyncio.CancelledError, Exception):
                pass
            self._monitor_task = None
        if self._slo_task is not None:
            self._slo_task.cancel()
            try:
                await self._slo_task
            except (asyncio.CancelledError, Exception):
                pass
            self._slo_task = None
        await self.engine.aclose()
        await self.server.close()
        self.store.close()

    # --- push handlers -----------------------------------------------------

    async def _backup_matched(self, msg: wire.BackupMatched) -> None:
        """Record the negotiated allowance for both roles
        (send.rs:312-335)."""
        self.store.add_peer_negotiated(msg.destination_id,
                                       msg.storage_available)
        self.messenger.log(
            f"matched with {bytes(msg.destination_id).hex()[:8]} for "
            f"{msg.storage_available} bytes")

    async def _accept_peer_data(self, source: bytes, transport) -> None:
        writer = ReceivedFilesWriter(self.store, source)
        count = await Receiver(transport, writer.sink,
                               part_sink=writer.sink_part,
                               resume_query=writer.resume_offer).run()
        self.messenger.log(
            f"stored {count} files for peer {bytes(source).hex()[:8]}")

    async def _serve_restore(self, source: bytes, transport) -> None:
        sent = await self.node.serve_restore(source, transport)
        self.messenger.log(
            f"served {sent} files back to {bytes(source).hex()[:8]}")

    async def _serve_restore_fetch(self, source: bytes, transport) -> None:
        sent = await self.node.serve_restore_fetch(source, transport)
        self.messenger.log(
            f"served {sent} fetched item(s) back to "
            f"{bytes(source).hex()[:8]}")

    async def _serve_reclaim(self, source: bytes, transport) -> None:
        freed = await self.node.serve_reclaim(source, transport)
        self.messenger.log(
            f"reclaimed {freed} byte(s) for {bytes(source).hex()[:8]}")

    async def _serve_audit(self, source: bytes, transport) -> None:
        answered = await self.node.serve_audit(source, transport,
                                               self.engine.backend)
        self.messenger.log(
            f"answered {answered} audit challenges for "
            f"{bytes(source).hex()[:8]}")

    async def _audit_due(self, msg: wire.AuditDue) -> None:
        """Server nudge: another client's audit of this peer failed."""
        self.engine.note_audit_due(msg.peer_id)
        self.messenger.log(
            f"audit of {bytes(msg.peer_id).hex()[:8]} requested by server")

    # --- commands (ws_dispatcher.rs:16-23) ---------------------------------

    async def backup(self, root: Optional[Path] = None) -> bytes:
        self.messenger.backup_started()
        try:
            snapshot = await self.engine.run_backup(root)
            self.messenger.backup_finished(snapshot)
            return snapshot
        except Exception as e:
            self.messenger.log(f"backup failed: {e}")
            raise

    async def audit(self) -> dict:
        """Run one verifier round over every peer whose audit is due."""
        return await self.engine.run_audit_round()

    async def restore(self, dest: Optional[Path] = None) -> Path:
        self.messenger.restore_started()
        try:
            path = await self.engine.run_restore(dest)
            self.messenger.restore_finished()
            return path
        except Exception as e:
            self.messenger.log(f"restore failed: {e}")
            raise
