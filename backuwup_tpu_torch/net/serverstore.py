"""Swappable server storage backend (the PR-10 scale-out seam).

Counterpart of ``backuwup_tpu/net/serverstore.py``, copied so that the
port imports nothing of the JAX package. The schema, the SQL and the
crash-site names are the reference's, so each package opens a database the
other wrote.

The coordination plane's persistent state is small and *naturally
shard-keyed*: every row the server writes — client identity, negotiation
edges, snapshots, audit verdicts, repair reports — is keyed by a client
pubkey (or a pubkey pair).  :class:`ServerStore` pins that contract down
as an abstract interface so the request tier in ``net/server.py`` stays
stateless: a Postgres/Vitess-style horizontally sharded twin can slot in
behind the same method set, routing each call by its leading pubkey
argument, without the handlers changing.

:class:`SqliteServerStore` is the embedded implementation, in two modes:

* **write-behind (default)** — a single writer thread owns the sqlite
  connection; every operation (reads included, which buys read-your-
  writes ordering for free) is submitted to an op queue and executed on
  that thread.  The writer drains whatever has queued since the last
  batch and commits ONCE per drain — group commit: under load, hundreds
  of single-row writes amortize one ``COMMIT`` (and one fsync when
  fsync discipline is on).  Callers get a future that resolves only
  *after* the commit, so an ``await store.aio.save_snapshot(...)`` in a
  handler is a durability barrier: the response cannot be written until
  the row is committed, yet the event loop never blocks — the commit
  happens on the writer thread (asserted by the swarm test's event-loop
  stall detector and by :attr:`commit_threads`).
* **direct** (``write_behind=False``, the :class:`ServerDB` shim) — the
  pre-PR-10 shape: every call executes inline on the calling thread and
  commits immediately.  Kept as the measured baseline for bench config
  ``12_swarm`` and for tests that predate the writer thread.  Unlike
  the original, calls are serialized under an RLock: the original
  shared one ``check_same_thread=False`` connection across threads with
  no serialization at all (the latent bug this PR's regression test
  hammers).

Fsync discipline follows ``utils/durable.py`` semantics: when
``durable.FSYNC_ENABLED`` (the ``BKW_FSYNC`` switch) a file-backed
database runs ``PRAGMA synchronous=FULL`` so a group commit is a real
durability barrier; with fsync disabled it drops to ``NORMAL`` (the
pure-tmpfs test posture).  Both store modes apply the same pragma so the
bench's baseline-vs-sharded comparison is durability-for-durability.
"""

from __future__ import annotations

import abc
import asyncio
import json
import queue
import sqlite3
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from .. import defaults
from ..obs import metrics as obs_metrics
from ..utils import durable, faults
from .ring import partition_of as ring_partition_of

_COMMITS = obs_metrics.counter(
    "bkw_server_store_commits_total",
    "Server-store sqlite commits by mode (group = write-behind batch)",
    ("mode",))
_BATCH_OPS = obs_metrics.histogram(
    "bkw_server_store_batch_ops",
    "Operations drained per write-behind group commit",
    buckets=obs_metrics.log_buckets(1.0, 2.0, 11))
_OP_QUEUE_DEPTH = obs_metrics.gauge(
    "bkw_server_store_queue_depth",
    "Write-behind operations waiting for the writer thread")

# --- replication families (docs/server.md §Replication) ----------------------
_REPL_SHIPS = obs_metrics.counter(
    "bkw_repl_ship_total",
    "Log-ship attempts to ring successors by outcome (acked / gap_refill /"
    " fenced / failed / degraded)", ("outcome",))
_REPL_SHIP_SECONDS = obs_metrics.histogram(
    "bkw_repl_ship_seconds",
    "Wall seconds per successor ship RPC (writer thread, inside the group"
    " commit)", buckets=obs_metrics.log_buckets(1e-4, 2.0, 16))
_REPL_LOG_RECORDS = obs_metrics.counter(
    "bkw_repl_log_records_total",
    "Operation-log records appended, by the appender's role", ("role",))
_REPL_ACK_LAG = obs_metrics.gauge(
    "bkw_repl_ack_lag_records",
    "Primary-side replication lag: log records not yet acked by the most"
    " current live successor")
_REPL_PROMOTES = obs_metrics.counter(
    "bkw_repl_promotes_total",
    "Successor promotions (epoch bump + log-tail replay)")
_REPL_PROMOTE_SECONDS = obs_metrics.histogram(
    "bkw_repl_promote_seconds",
    "Wall seconds per promotion (epoch commit + replay)",
    buckets=obs_metrics.log_buckets(1e-3, 2.0, 14))
_REPL_FENCED = obs_metrics.counter(
    "bkw_repl_fenced_total",
    "Stale-epoch ships refused (zombie primary fenced)")
_REPL_EPOCH = obs_metrics.gauge(
    "bkw_repl_epoch",
    "Current fencing epoch per store partition", ("partition",))
_REPL_FORWARDS = obs_metrics.counter(
    "bkw_repl_forwards_total",
    "Cross-node op forwards to a partition's owner by outcome",
    ("outcome",))

# --- replication crash seams: import-time registration so the crash matrix
# discovers them without a hand-kept list (C1 convention; BKW003 resolves
# these module-level constants at their crashpoint() call sites) --------------
_CP_REPL_APPEND_PRE = faults.register_crash_site("repl.log.append.pre")
_CP_REPL_APPEND_POST = faults.register_crash_site("repl.log.append.post")
_CP_REPL_SHIP_ACKED = faults.register_crash_site("repl.ship.acked")
_CP_REPL_PROMOTE_PRE = faults.register_crash_site("repl.promote.pre")
_CP_REPL_PROMOTE_POST = faults.register_crash_site("repl.promote.post")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS clients (
    pubkey BLOB PRIMARY KEY,
    registered REAL NOT NULL,
    last_login REAL
);
CREATE TABLE IF NOT EXISTS peer_backups (
    source BLOB NOT NULL,
    destination BLOB NOT NULL,
    size_negotiated INTEGER NOT NULL,
    timestamp REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS peer_backups_by_source
    ON peer_backups (source, destination);
CREATE INDEX IF NOT EXISTS peer_backups_by_destination
    ON peer_backups (destination, source);
CREATE TABLE IF NOT EXISTS snapshots (
    client_pubkey BLOB NOT NULL,
    snapshot_hash BLOB NOT NULL,
    timestamp REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS snapshots_by_client
    ON snapshots (client_pubkey, timestamp);
CREATE TABLE IF NOT EXISTS audit_reports (
    reporter BLOB NOT NULL,
    peer BLOB NOT NULL,
    passed INTEGER NOT NULL,
    detail TEXT NOT NULL DEFAULT '',
    timestamp REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS audit_reports_by_peer
    ON audit_reports (peer, timestamp);
CREATE TABLE IF NOT EXISTS repair_reports (
    reporter BLOB NOT NULL,
    peer BLOB NOT NULL,
    packfiles_lost INTEGER NOT NULL,
    bytes_lost INTEGER NOT NULL,
    bytes_replaced INTEGER NOT NULL,
    timestamp REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS metadata (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
"""

#: Bump when the schema changes shape; pre-versioning databases (PR 1 and
#: earlier, which had no ``metadata`` table) count as version 1.
SCHEMA_VERSION = 2

#: THE migration seam: ``{from_version: [SQL statements]}`` applied in
#: sequence by the boot-time migrate to reach ``from_version + 1``.
#: Statements must be idempotent (IF NOT EXISTS / OR IGNORE) because a
#: crash between a migration and the version stamp replays it on the next
#: boot.  A Postgres twin of SqliteServerStore would run the same ladder.
_MIGRATIONS = {
    # v1 (PR 1) -> v2: repair_reports + the metadata table itself.  Both
    # already appear in _SCHEMA's CREATE IF NOT EXISTS, so this rung is
    # empty — it exists to document the pattern for the next real change.
    1: [],
}


class ServerStore(abc.ABC):
    """Abstract coordination-plane store, keyed by client pubkey.

    Every method's FIRST pubkey argument is its shard key; a distributed
    implementation routes on it.  ``peer_backups`` rows are dual-homed
    (one copy under each endpoint's shard) in such a deployment — the
    sqlite implementation keeps one table and both query directions.

    Implementations must expose:

    * the synchronous method set below (tests and setup scripts call
      them directly; they may block briefly),
    * :attr:`aio` — the same methods as awaitables that never block the
      event loop AND, for writes, resolve only once the write is
      durable (the request tier's durability barrier),
    * :meth:`flush` / :meth:`close` lifecycle hooks.
    """

    @abc.abstractmethod
    def register_client(self, pubkey: bytes) -> None: ...

    @abc.abstractmethod
    def client_exists(self, pubkey: bytes) -> bool: ...

    @abc.abstractmethod
    def client_update_logged_in(self, pubkey: bytes) -> None: ...

    @abc.abstractmethod
    def save_storage_negotiated(self, source: bytes, destination: bytes,
                                size: int) -> None: ...

    @abc.abstractmethod
    def delete_storage_negotiated(self, source: bytes, destination: bytes,
                                  size: int) -> None: ...

    @abc.abstractmethod
    def save_snapshot(self, pubkey: bytes, snapshot_hash: bytes) -> None: ...

    @abc.abstractmethod
    def get_latest_client_snapshot(self,
                                   pubkey: bytes) -> Optional[bytes]: ...

    @abc.abstractmethod
    def get_client_negotiated_peers(self, pubkey: bytes) -> list: ...

    @abc.abstractmethod
    def get_clients_storing_on(self, pubkey: bytes) -> list: ...

    @abc.abstractmethod
    def save_audit_report(self, reporter: bytes, peer: bytes, passed: bool,
                          detail: str) -> None: ...

    @abc.abstractmethod
    def save_repair_report(self, reporter: bytes, peer: bytes,
                           packfiles_lost: int, bytes_lost: int,
                           bytes_replaced: int) -> None: ...

    @abc.abstractmethod
    def reclaim_negotiation(self, client: bytes, peer: bytes) -> int: ...

    @abc.abstractmethod
    def audit_failing_reporters(self, peer: bytes,
                                window_s: float) -> int: ...

    @abc.abstractmethod
    def schema_version(self) -> int: ...

    def flush(self) -> None:
        """Barrier: every previously submitted write is durable on
        return."""

    def close(self) -> None:
        """Stop background machinery; the store stays usable for
        post-shutdown reads (tests inspect state after server.stop())."""


class _AioFacade:
    """``store.aio.<method>(...)`` — the handler-facing async view.

    Write-behind: wraps the op's :class:`~concurrent.futures.Future` so
    the coroutine resumes only after the writer thread's group commit.
    Direct mode: runs the sync method inline on the event loop —
    deliberately preserving the pre-PR-10 blocking-commit behavior for
    the bench baseline.
    """

    def __init__(self, store: "SqliteServerStore"):
        self._store = store

    def __getattr__(self, name: str):
        op = getattr(type(self._store), "_op_" + name, None)
        if op is None:
            raise AttributeError(name)
        store = self._store

        async def call(*args):
            if not store.write_behind:
                return getattr(store, name)(*args)
            import asyncio
            return await asyncio.wrap_future(store._submit(op, args))

        call.__name__ = name
        return call


class SqliteServerStore(ServerStore):
    """Embedded sqlite ServerStore; see the module docstring for the
    write-behind/direct split."""

    def __init__(self, path, write_behind: bool = True):
        self.path = path
        self.write_behind = bool(write_behind)
        #: thread idents observed executing COMMIT for request-path ops
        #: (NOT the constructor's schema bootstrap) — the swarm test
        #: asserts the event-loop thread never appears here.
        self.commit_threads: set = set()
        self._db = sqlite3.connect(path, check_same_thread=False)
        if path != ":memory:":
            self._db.execute("PRAGMA journal_mode=WAL")
            # Federation opens the same partition files from several
            # store instances (node revive, multi-process bench legs):
            # wait out a sibling's group commit instead of raising
            # "database is locked" into a request handler.
            self._db.execute("PRAGMA busy_timeout=5000")
            # fsync-disciplined group commit (utils/durable.py semantics):
            # FULL makes each COMMIT a durability barrier; with fsync
            # globally off (BKW_FSYNC=0 test runs) NORMAL suffices.
            self._db.execute("PRAGMA synchronous=%s"
                             % ("FULL" if durable.FSYNC_ENABLED
                                else "NORMAL"))
        self._db.executescript(_SCHEMA)
        self._db.commit()
        self._migrate()  # raises synchronously on a newer-schema database
        self._direct_lock = threading.RLock()
        self._submit_lock = threading.Lock()
        self._closed = False
        self._ops: "queue.SimpleQueue" = queue.SimpleQueue()
        self._depth = 0
        self._writer: Optional[threading.Thread] = None
        if self.write_behind:
            self._writer = threading.Thread(
                target=self._writer_loop, name="serverstore-writer",
                daemon=True)
            self._writer.start()

    # --- write-behind machinery --------------------------------------------

    def _submit(self, op, args) -> Future:
        fut: Future = Future()
        with self._submit_lock:
            if self._closed or not self.write_behind:
                # post-close (or direct-mode) fallback: run inline,
                # serialized, committed immediately
                try:
                    with self._direct_lock:
                        result = op(self._db, *args)
                        self._commit("direct")
                    fut.set_result(result)
                except BaseException as e:
                    fut.set_exception(e)
                return fut
            self._ops.put((op, args, fut))
            self._depth += 1
            _OP_QUEUE_DEPTH.set(self._depth)
        return fut

    def _writer_loop(self) -> None:
        while True:
            head = self._ops.get()
            if head is None:
                return
            batch = [head]
            # group commit: drain everything already queued (bounded so a
            # firehose cannot starve the commit), execute, commit ONCE,
            # then resolve every future — durability before acknowledgment
            while len(batch) < defaults.SERVER_STORE_MAX_BATCH:
                try:
                    nxt = self._ops.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._ops.put(None)  # re-arm shutdown for next round
                    break
                batch.append(nxt)
            with self._submit_lock:
                self._depth -= len(batch)
                _OP_QUEUE_DEPTH.set(max(self._depth, 0))
            try:
                results = self._execute_batch(batch)
            except faults.CrashInjected as e:
                # an armed replication-seam crash fired mid-batch: the
                # process is "dead" — fail the batch so waiters observe
                # it, and stop the writer (recovery happens at reopen)
                for _op, _args, fut in batch:
                    fut.set_exception(e)
                return
            except BaseException as e:
                # batch-level failure (e.g. a fenced zombie primary):
                # nothing was applied; fail every waiter, stay alive
                for _op, _args, fut in batch:
                    fut.set_exception(e)
                continue
            _BATCH_OPS.observe(float(len(batch)))
            for (ok, value), (_op, _args, fut) in zip(results, batch):
                if ok:
                    fut.set_result(value)
                else:
                    fut.set_exception(value)

    def _execute_batch(self, batch) -> list:
        """Execute one drained batch against the writer's connection and
        commit ONCE; returns ``[(ok, value-or-exc), ...]`` aligned with
        ``batch``.  The replication subclass overrides this — the log
        append + successor ship happen here, inside the durability
        barrier, before any caller's future resolves."""
        results = []
        for op, args, _fut in batch:
            try:
                results.append((True, op(self._db, *args)))
            except BaseException as e:  # per-op isolation
                results.append((False, e))
        self._commit("group")
        return results

    def _commit(self, mode: str) -> None:
        if self._db.in_transaction:
            self._db.commit()
            _COMMITS.inc(mode=mode)
            self.commit_threads.add(threading.get_ident())

    def flush(self) -> None:
        if self.write_behind and not self._closed:
            self._submit(lambda _conn: None, ()).result()

    def close(self) -> None:
        """Drain the op queue, stop the writer thread, and flip to the
        inline fallback (the connection stays open so post-shutdown test
        reads keep working)."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        if self._writer is not None:
            self._ops.put(None)
            self._writer.join(timeout=10)
            self._writer = None

    # --- sync + async facades ----------------------------------------------

    @property
    def aio(self) -> _AioFacade:
        return _AioFacade(self)

    def _run(self, op, *args):
        if self.write_behind:
            return self._submit(op, args).result()
        with self._direct_lock:
            result = op(self._db, *args)
            self._commit("direct")
            return result

    # --- schema ------------------------------------------------------------

    def _migrate(self) -> None:
        """Boot-time schema version check (runs on the constructing
        thread, before the writer starts, so version errors raise
        synchronously).

        * fresh or pre-versioning database -> run the ladder from v1 and
          stamp :data:`SCHEMA_VERSION` (the _SCHEMA script is idempotent,
          so replaying it on a v1 database upgrades it in place);
        * versioned database older than the code -> apply each rung of
          :data:`_MIGRATIONS` in order, stamping after each one;
        * database NEWER than the code -> refuse to start: old code
          writing rows a newer schema reinterprets is silent corruption.
        """
        row = self._db.execute(
            "SELECT value FROM metadata WHERE key = 'schema_version'"
        ).fetchone()
        version = int(row[0]) if row is not None else 1
        if version > SCHEMA_VERSION:
            raise RuntimeError(
                f"database schema v{version} is newer than this server"
                f" (v{SCHEMA_VERSION}); upgrade the server binary")
        while version < SCHEMA_VERSION:
            for stmt in _MIGRATIONS.get(version, ()):
                self._db.execute(stmt)
            version += 1
            self._db.execute(
                "INSERT INTO metadata (key, value) VALUES"
                " ('schema_version', ?) ON CONFLICT(key)"
                " DO UPDATE SET value = excluded.value", (str(version),))
            self._db.commit()
        if row is None:
            self._db.execute(
                "INSERT OR IGNORE INTO metadata (key, value) VALUES"
                " ('schema_version', ?)", (str(SCHEMA_VERSION),))
            self._db.commit()

    # --- operations (each = one statement batch on the writer's conn) ------
    # The _op_* staticmethods are the single source of truth: the sync
    # facade and store.aio both execute exactly these against the one
    # connection, so ordering and read-your-writes hold in every mode.

    @staticmethod
    def _op_schema_version(conn) -> int:
        row = conn.execute(
            "SELECT value FROM metadata WHERE key = 'schema_version'"
        ).fetchone()
        return int(row[0])

    # Write ops take a trailing ``ts`` (defaulted to now) so a replicated
    # log replay reproduces byte-identical rows: the primary stamps the
    # wall clock ONCE into the log record, and every replica applies that
    # stamp, not its own clock.

    @staticmethod
    def _op_register_client(conn, pubkey: bytes,
                            ts: Optional[float] = None) -> None:
        conn.execute(
            "INSERT OR IGNORE INTO clients (pubkey, registered) VALUES (?, ?)",
            (pubkey, time.time() if ts is None else ts))

    @staticmethod
    def _op_client_exists(conn, pubkey: bytes) -> bool:
        return conn.execute("SELECT 1 FROM clients WHERE pubkey = ?",
                            (pubkey,)).fetchone() is not None

    @staticmethod
    def _op_client_update_logged_in(conn, pubkey: bytes,
                                    ts: Optional[float] = None) -> None:
        conn.execute("UPDATE clients SET last_login = ? WHERE pubkey = ?",
                     (time.time() if ts is None else ts, pubkey))

    @staticmethod
    def _op_save_storage_negotiated(conn, source: bytes, destination: bytes,
                                    size: int,
                                    ts: Optional[float] = None) -> None:
        conn.execute(
            "INSERT INTO peer_backups (source, destination, size_negotiated,"
            " timestamp) VALUES (?, ?, ?, ?)",
            (source, destination, size, time.time() if ts is None else ts))

    @staticmethod
    def _op_delete_storage_negotiated(conn, source: bytes,
                                      destination: bytes, size: int) -> None:
        conn.execute(
            "DELETE FROM peer_backups WHERE rowid = ("
            " SELECT rowid FROM peer_backups WHERE source = ?"
            " AND destination = ? AND size_negotiated = ?"
            " ORDER BY timestamp DESC LIMIT 1)",
            (source, destination, size))

    @staticmethod
    def _op_save_snapshot(conn, pubkey: bytes, snapshot_hash: bytes,
                          ts: Optional[float] = None) -> None:
        conn.execute(
            "INSERT INTO snapshots (client_pubkey, snapshot_hash, timestamp)"
            " VALUES (?, ?, ?)",
            (pubkey, snapshot_hash, time.time() if ts is None else ts))

    @staticmethod
    def _op_get_latest_client_snapshot(conn,
                                       pubkey: bytes) -> Optional[bytes]:
        row = conn.execute(
            "SELECT snapshot_hash FROM snapshots WHERE client_pubkey = ?"
            " ORDER BY timestamp DESC LIMIT 1", (pubkey,)).fetchone()
        return None if row is None else bytes(row[0])

    @staticmethod
    def _op_get_client_negotiated_peers(conn, pubkey: bytes) -> list:
        rows = conn.execute(
            "SELECT DISTINCT destination FROM peer_backups WHERE source = ?",
            (pubkey,)).fetchall()
        return [bytes(r[0]) for r in rows]

    @staticmethod
    def _op_get_clients_storing_on(conn, pubkey: bytes) -> list:
        rows = conn.execute(
            "SELECT DISTINCT source FROM peer_backups WHERE destination = ?",
            (pubkey,)).fetchall()
        return [bytes(r[0]) for r in rows]

    @staticmethod
    def _op_save_audit_report(conn, reporter: bytes, peer: bytes,
                              passed: bool, detail: str,
                              ts: Optional[float] = None) -> None:
        conn.execute(
            "INSERT INTO audit_reports (reporter, peer, passed, detail,"
            " timestamp) VALUES (?, ?, ?, ?, ?)",
            (reporter, peer, int(passed), detail,
             time.time() if ts is None else ts))

    @staticmethod
    def _op_save_repair_report(conn, reporter: bytes, peer: bytes,
                               packfiles_lost: int, bytes_lost: int,
                               bytes_replaced: int,
                               ts: Optional[float] = None) -> None:
        conn.execute(
            "INSERT INTO repair_reports (reporter, peer, packfiles_lost,"
            " bytes_lost, bytes_replaced, timestamp) VALUES (?, ?, ?, ?, ?, ?)",
            (reporter, peer, int(packfiles_lost), int(bytes_lost),
             int(bytes_replaced), time.time() if ts is None else ts))

    @staticmethod
    def _op_reclaim_negotiation(conn, client: bytes, peer: bytes) -> int:
        cur = conn.execute(
            "DELETE FROM peer_backups WHERE (source = ? AND destination = ?)"
            " OR (source = ? AND destination = ?)",
            (client, peer, peer, client))
        return cur.rowcount

    @staticmethod
    def _op_audit_failing_reporters(conn, peer: bytes,
                                    window_s: float) -> int:
        rows = conn.execute(
            "SELECT reporter, passed FROM audit_reports"
            " WHERE peer = ? AND timestamp >= ? ORDER BY timestamp",
            (peer, time.time() - window_s)).fetchall()
        latest: Dict[bytes, int] = {}
        for reporter, passed in rows:
            latest[bytes(reporter)] = passed
        return sum(1 for passed in latest.values() if not passed)

    # --- the ServerDB-compatible sync surface -------------------------------

    def schema_version(self) -> int:
        return self._run(self._op_schema_version)

    def register_client(self, pubkey: bytes) -> None:
        self._run(self._op_register_client, pubkey)

    def client_exists(self, pubkey: bytes) -> bool:
        return self._run(self._op_client_exists, pubkey)

    def client_update_logged_in(self, pubkey: bytes) -> None:
        self._run(self._op_client_update_logged_in, pubkey)

    def save_storage_negotiated(self, source: bytes, destination: bytes,
                                size: int) -> None:
        self._run(self._op_save_storage_negotiated, source, destination,
                  size)

    def delete_storage_negotiated(self, source: bytes, destination: bytes,
                                  size: int) -> None:
        """Roll back one just-recorded negotiation (failed-push
        compensation in matchmaking fulfill)."""
        self._run(self._op_delete_storage_negotiated, source, destination,
                  size)

    def save_snapshot(self, pubkey: bytes, snapshot_hash: bytes) -> None:
        self._run(self._op_save_snapshot, pubkey, snapshot_hash)

    def get_latest_client_snapshot(self, pubkey: bytes) -> Optional[bytes]:
        return self._run(self._op_get_latest_client_snapshot, pubkey)

    def get_client_negotiated_peers(self, pubkey: bytes) -> list:
        return self._run(self._op_get_client_negotiated_peers, pubkey)

    def get_clients_storing_on(self, pubkey: bytes) -> list:
        """Sources with data on ``pubkey`` (the reverse negotiation
        edge)."""
        return self._run(self._op_get_clients_storing_on, pubkey)

    def save_audit_report(self, reporter: bytes, peer: bytes, passed: bool,
                          detail: str) -> None:
        self._run(self._op_save_audit_report, reporter, peer, passed,
                  detail)

    def save_repair_report(self, reporter: bytes, peer: bytes,
                           packfiles_lost: int, bytes_lost: int,
                           bytes_replaced: int) -> None:
        self._run(self._op_save_repair_report, reporter, peer,
                  packfiles_lost, bytes_lost, bytes_replaced)

    def reclaim_negotiation(self, client: bytes, peer: bytes) -> int:
        """Retire every negotiation edge between ``client`` and a lost
        ``peer`` (both directions): the allowance is unusable, and
        restore peer lists must stop naming the dead peer.  Returns rows
        removed."""
        return self._run(self._op_reclaim_negotiation, client, peer)

    def audit_failing_reporters(self, peer: bytes, window_s: float) -> int:
        """Distinct reporters whose LATEST report on ``peer`` within the
        window is a failure.  A later pass from the same reporter clears
        its vote, so a recovered peer re-enters matchmaking without any
        server-side state surgery."""
        return self._run(self._op_audit_failing_reporters, peer, window_s)


class ServerDB(SqliteServerStore):
    """The pre-PR-10 direct-mode store, kept name-compatible.

    Everything executes inline on the calling thread with an immediate
    commit (now under a lock — the original shared its connection across
    threads unserialized).  ``CoordinationServer(legacy=True)`` and the
    bench's single-lock baseline leg use this; new code wants
    :class:`SqliteServerStore`.
    """

    def __init__(self, path):
        super().__init__(path, write_behind=False)


class _PartitionedAio:
    """``store.aio.<method>`` for :class:`PartitionedServerStore`:
    routed ops delegate to the owning partition's own aio facade;
    fan-out ops gather across every partition and merge."""

    def __init__(self, store: "PartitionedServerStore"):
        self._store = store

    def __getattr__(self, name: str):
        if getattr(type(self._store.parts[0]), "_op_" + name, None) is None:
            raise AttributeError(name)
        store = self._store

        async def call(*args):
            return await store._dispatch_async(name, args)

        call.__name__ = name
        return call


class PartitionedServerStore(ServerStore):
    """N per-partition sqlite stores behind the one ServerStore ABC.

    The federation deployment unit (docs/server.md §Federation): every
    coordination node opens the SAME partition directory and routes each
    call by its leading pubkey (``ring.partition_of`` — the convention
    the ABC docstring promises), so store correctness never depends on
    WHICH node served a request.  A wrong-node arrival is merely slower
    (cross-partition WAL contention), never wrong — and node kill/revive
    cannot lose state because the partition files outlive any one
    server instance.

    Cross-partition reads fan out and merge:

    * ``get_clients_storing_on`` — reverse edges live under each
      source's partition: union (first-seen order) across partitions.
    * ``audit_failing_reporters`` — all of one reporter's reports land
      in the reporter's partition, so each partition's latest-per-
      reporter verdict is already globally latest: sum the counts.
    * ``reclaim_negotiation`` — the two edge directions live under the
      two endpoints' partitions: run on both (once if they collide) and
      sum removed rows.

    Everything else routes to exactly one partition, preserving the
    single-writer group-commit durability barrier per partition.
    """

    _FAN_OUT = frozenset({"get_clients_storing_on",
                          "audit_failing_reporters"})

    def __init__(self, root, partitions: Optional[int] = None,
                 write_behind: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        n = max(1, int(partitions or defaults.SERVER_STORE_PARTITIONS))
        self.write_behind = bool(write_behind)
        self.parts: List[SqliteServerStore] = [
            SqliteServerStore(str(self.root / f"part_{i:02d}.db"),
                              write_behind=write_behind)
            for i in range(n)]

    def partition_for(self, pubkey: bytes) -> SqliteServerStore:
        return self.parts[ring_partition_of(pubkey, len(self.parts))]

    @property
    def commit_threads(self) -> set:
        out: set = set()
        for p in self.parts:
            out |= p.commit_threads
        return out

    # --- dispatch ----------------------------------------------------------

    def _reclaim_targets(self, client: bytes,
                         peer: bytes) -> List[SqliteServerStore]:
        a, b = self.partition_for(client), self.partition_for(peer)
        return [a] if a is b else [a, b]

    @staticmethod
    def _merge_distinct(results: List[list]) -> list:
        seen, out = set(), []
        for part in results:
            for pk in part:
                if pk not in seen:
                    seen.add(pk)
                    out.append(pk)
        return out

    def _dispatch_sync(self, name: str, args):
        if name == "schema_version":
            return self.parts[0].schema_version()
        if name in self._FAN_OUT:
            results = [getattr(p, name)(*args) for p in self.parts]
            if name == "audit_failing_reporters":
                return sum(results)
            return self._merge_distinct(results)
        if name == "reclaim_negotiation":
            return sum(p.reclaim_negotiation(*args)
                       for p in self._reclaim_targets(*args))
        return getattr(self.partition_for(args[0]), name)(*args)

    async def _dispatch_async(self, name: str, args):
        if name == "schema_version":
            return await self.parts[0].aio.schema_version()
        if name in self._FAN_OUT:
            results = await asyncio.gather(
                *(getattr(p.aio, name)(*args) for p in self.parts))
            if name == "audit_failing_reporters":
                return sum(results)
            return self._merge_distinct(list(results))
        if name == "reclaim_negotiation":
            counts = await asyncio.gather(
                *(p.aio.reclaim_negotiation(*args)
                  for p in self._reclaim_targets(*args)))
            return sum(counts)
        part = self.partition_for(args[0])
        return await getattr(part.aio, name)(*args)

    @property
    def aio(self) -> _PartitionedAio:
        return _PartitionedAio(self)

    # --- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        for p in self.parts:
            p.flush()

    def close(self) -> None:
        for p in self.parts:
            p.close()

    # --- the ServerStore surface, routed ------------------------------------

    def schema_version(self) -> int:
        return self._dispatch_sync("schema_version", ())

    def register_client(self, pubkey: bytes) -> None:
        self._dispatch_sync("register_client", (pubkey,))

    def client_exists(self, pubkey: bytes) -> bool:
        return self._dispatch_sync("client_exists", (pubkey,))

    def client_update_logged_in(self, pubkey: bytes) -> None:
        self._dispatch_sync("client_update_logged_in", (pubkey,))

    def save_storage_negotiated(self, source: bytes, destination: bytes,
                                size: int) -> None:
        self._dispatch_sync("save_storage_negotiated",
                            (source, destination, size))

    def delete_storage_negotiated(self, source: bytes, destination: bytes,
                                  size: int) -> None:
        self._dispatch_sync("delete_storage_negotiated",
                            (source, destination, size))

    def save_snapshot(self, pubkey: bytes, snapshot_hash: bytes) -> None:
        self._dispatch_sync("save_snapshot", (pubkey, snapshot_hash))

    def get_latest_client_snapshot(self, pubkey: bytes) -> Optional[bytes]:
        return self._dispatch_sync("get_latest_client_snapshot", (pubkey,))

    def get_client_negotiated_peers(self, pubkey: bytes) -> list:
        return self._dispatch_sync("get_client_negotiated_peers", (pubkey,))

    def get_clients_storing_on(self, pubkey: bytes) -> list:
        return self._dispatch_sync("get_clients_storing_on", (pubkey,))

    def save_audit_report(self, reporter: bytes, peer: bytes, passed: bool,
                          detail: str) -> None:
        self._dispatch_sync("save_audit_report",
                            (reporter, peer, passed, detail))

    def save_repair_report(self, reporter: bytes, peer: bytes,
                           packfiles_lost: int, bytes_lost: int,
                           bytes_replaced: int) -> None:
        self._dispatch_sync("save_repair_report",
                            (reporter, peer, packfiles_lost, bytes_lost,
                             bytes_replaced))

    def reclaim_negotiation(self, client: bytes, peer: bytes) -> int:
        return self._dispatch_sync("reclaim_negotiation", (client, peer))

    def audit_failing_reporters(self, peer: bytes, window_s: float) -> int:
        return self._dispatch_sync("audit_failing_reporters",
                                   (peer, window_s))


# --- replicated coordination metadata (docs/server.md §Replication) ----------

#: Mutating operations, and whether each takes the trailing replay
#: timestamp.  Only these ship: reads never enter the log, so a replica
#: replay touches exactly the rows the primary's commit touched.
_REPL_WRITE_OPS: Dict[str, bool] = {
    "register_client": True,
    "client_update_logged_in": True,
    "save_storage_negotiated": True,
    "delete_storage_negotiated": False,
    "save_snapshot": True,
    "save_audit_report": True,
    "save_repair_report": True,
    "reclaim_negotiation": False,
}


def encode_value(v: Any) -> Any:
    """JSON-safe encoding for log records and forwarded op args/results:
    bytes ride as ``{"__b": hex}``, containers recurse, scalars pass."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        return {"__b": bytes(v).hex()}
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    return v


def decode_value(v: Any) -> Any:
    if isinstance(v, dict) and "__b" in v:
        return bytes.fromhex(v["__b"])
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


class ReplicationFenced(RuntimeError):
    """A write was refused because this node's epoch is stale — a
    successor was promoted past it.  The holder must rejoin as a
    successor; the new owner (when known) rides along for rerouting."""

    def __init__(self, epoch: int, owner: Optional[str] = None,
                 partition: Optional[int] = None):
        super().__init__(
            f"partition fenced at epoch {epoch}"
            + (f" (owner {owner})" if owner else ""))
        self.epoch = int(epoch)
        self.owner = owner
        self.partition = partition


class OpLog:
    """Per-partition replicated operation log: append-only JSONL plus a
    durable epoch sidecar.

    * Records are ``{"lsn", "epoch", "op", "args", "ts"}``, one per
      line, bytes args hex-tagged (:func:`encode_value`).  Appends are
      flushed and fsynced under the ``BKW_FSYNC`` discipline before the
      caller proceeds — the record IS the durability unit the write's
      future waits on.
    * A torn tail (crash mid-append) is tolerated on load: parsing stops
      at the first undecodable line, so only fully-durable records are
      ever replayed — the classic redo-log contract.
    * The fencing epoch lives in a ``<log>.meta.json`` sidecar committed
      via ``durable.write_replace``; it changes only at promotion (bump)
      and higher-epoch ship adoption, both crashpoint-adjacent call
      sites.
    """

    def __init__(self, path):
        self.path = Path(path)
        self.meta_path = self.path.with_name(self.path.name + ".meta.json")
        self.epoch = 0
        #: set durably when a divergent tail is truncated: records the
        #: store's sqlite may reflect log records that no longer exist,
        #: so the owner must rebuild from the log before trusting it
        self.dirty = False
        self.records: List[dict] = []
        self._load()

    def _load(self) -> None:
        if self.meta_path.exists():
            try:
                meta = json.loads(self.meta_path.read_text())
                self.epoch = int(meta.get("epoch", 0))
                self.dirty = bool(meta.get("dirty", False))
            except (ValueError, OSError):
                self.epoch = 0
                self.dirty = False
        if not self.path.exists():
            return
        with open(self.path, "rb") as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                    int(rec["lsn"])
                except (ValueError, KeyError, TypeError):
                    break  # torn tail: a crash cut the last append short
                self.records.append(rec)

    @property
    def last_lsn(self) -> int:
        return int(self.records[-1]["lsn"]) if self.records else 0

    def tail(self, after_lsn: int) -> List[dict]:
        return [r for r in self.records if int(r["lsn"]) > after_lsn]

    @staticmethod
    def _lines(records: List[dict]) -> bytes:
        return b"".join(
            json.dumps(r, separators=(",", ":")).encode() + b"\n"
            for r in records)

    def append(self, records: List[dict]) -> None:
        with open(self.path, "ab") as fh:
            fh.write(self._lines(records))
        durable.fsync_file(self.path)
        self.records.extend(records)

    @staticmethod
    def _meta_bytes(epoch: int, dirty: bool) -> bytes:
        return json.dumps({"epoch": int(epoch),
                           "dirty": bool(dirty)}).encode()

    def set_epoch(self, epoch: int) -> None:
        # durable before in-memory: a crash between the two re-reads the
        # committed state at reopen (callers bracket with crashpoints)
        durable.write_replace(self.meta_path,
                              self._meta_bytes(epoch, self.dirty))
        self.epoch = int(epoch)

    def set_dirty(self, dirty: bool) -> None:
        durable.write_replace(self.meta_path,
                              self._meta_bytes(self.epoch, dirty))
        self.dirty = bool(dirty)

    def truncate_after(self, lsn: int) -> None:
        """Atomically drop every record with lsn > ``lsn`` — the
        divergent tail a fenced zombie logged but never got acked."""
        keep = [r for r in self.records if int(r["lsn"]) <= lsn]
        durable.write_replace(self.path, self._lines(keep))
        self.records = keep


class _ReplPartitionStore(SqliteServerStore):
    """One partition of a :class:`ReplicatedServerStore`: the sqlite
    store plus its operation log, successor chain, and fencing state.

    The write-behind group commit is extended, not replaced: the
    overridden :meth:`_execute_batch` stamps each mutating op into a log
    record, makes the records durable, ships them synchronously to the
    ring successors, and only then applies them to sqlite (advancing the
    ``repl_applied_lsn`` metadata row in the SAME transaction — the
    exactly-once cursor a replay consults) and resolves the batch's
    futures.  Crash anywhere in that sequence and either the records
    never became durable (no caller was acked) or a reopen/promote
    replays them idempotently.

    A node holds one of these per partition whether it owns it or not:
    a successor's copy accepts ships into its log (:meth:`accept_ship`)
    and applies NOTHING until :meth:`promote` — so its sqlite can never
    diverge from acked history, and a fenced zombie's unacked tail is a
    pure log artifact the truncation repairs.
    """

    def __init__(self, path, log_path, partition: int, node_id: str):
        self.partition = int(partition)
        self.node_id = str(node_id)
        self.log = OpLog(log_path)
        self.owner: Optional[str] = None
        self.successors: List[str] = []
        #: sync ship hook ``(node_id, payload) -> response dict``; runs
        #: on the writer thread (never the event loop), wired by the
        #: server layer / tests.  ``None`` = standalone, nothing ships.
        self.ship: Optional[Callable[[str, dict], dict]] = None
        self.fenced = False
        self._repl_lock = threading.RLock()
        self._acked: Dict[str, int] = {}
        self._ship_down: Dict[str, float] = {}
        super().__init__(path, write_behind=True)
        # reopen-time divergence repair: the durable dirty flag marks
        # an interrupted rebuild; a cursor past the log's end is the
        # flag's own crash window (truncation durable, flag not yet)
        if self.log.dirty or self.applied_lsn() > self.log.last_lsn:
            self._rebuild()
        _REPL_EPOCH.set(float(self.log.epoch), partition=str(partition))

    # --- primary side -------------------------------------------------------

    def _execute_batch(self, batch) -> list:
        with self._repl_lock:
            exec_args: Dict[int, tuple] = {}
            staged: List[dict] = []
            lsn = self.log.last_lsn
            pre_lsn = lsn
            for i, (op, args, _fut) in enumerate(batch):
                name = op.__name__
                name = name[4:] if name.startswith("_op_") else name
                takes_ts = _REPL_WRITE_OPS.get(name)
                if takes_ts is None:
                    continue  # read (or the flush no-op): never ships
                if self.fenced:
                    raise ReplicationFenced(self.log.epoch, self.owner,
                                            self.partition)
                lsn += 1
                rec = {"lsn": lsn, "epoch": self.log.epoch, "op": name,
                       "args": encode_value(list(args)),
                       "ts": round(time.time(), 6)}
                staged.append(rec)
                if takes_ts:
                    exec_args[i] = tuple(args) + (rec["ts"],)
            if staged:
                faults.crashpoint(_CP_REPL_APPEND_PRE)
                self.log.append(staged)
                faults.crashpoint(_CP_REPL_APPEND_POST)
                _REPL_LOG_RECORDS.inc(float(len(staged)), role="primary")
                self._ship_tail(staged)  # raises ReplicationFenced on a
                #                          stale epoch — nothing applied
                faults.crashpoint(_CP_REPL_SHIP_ACKED)
                # roll forward any older durable-but-unapplied tail (the
                # crash-between-ship-and-commit seam) in this same txn
                applied = self._op_applied_lsn(self._db)
                for rec in self.log.tail(applied):
                    if int(rec["lsn"]) > pre_lsn:
                        break
                    self._apply_record(self._db, rec)
            results = []
            for i, (op, args, _fut) in enumerate(batch):
                try:
                    results.append(
                        (True, op(self._db, *exec_args.get(i, args))))
                except BaseException as e:  # per-op isolation
                    results.append((False, e))
            if staged:
                self._set_applied(self._db, staged[-1]["lsn"])
            self._commit("group")
            return results

    def _ship_tail(self, records: List[dict]) -> None:
        """Synchronously ship freshly logged records to every live
        successor.  Requires no ack only when the chain is empty or
        entirely dark (degraded — counted, and the gap refills when a
        successor answers again); a fenced response raises."""
        chain = [n for n in self.successors if n != self.node_id]
        if not chain or self.ship is None:
            return
        payload = {"partition": self.partition, "epoch": self.log.epoch,
                   "from_lsn": records[0]["lsn"], "records": records}
        # Zero acks means the resolving write futures would be backed by
        # NOTHING but this node's disk — the one state the protocol
        # promises not to ack from.  So the first round honours the
        # ship-down backoff (don't stall the writer on known-dark
        # peers), but an ack-less batch retries the ENTIRE chain,
        # backoff ignored: a slow successor still beats no successor.
        acked: set = set()
        for attempt in range(defaults.REPL_SHIP_RETRIES + 1):
            now = time.time()
            for node in chain:
                if node in acked:
                    continue
                if attempt == 0 and self._ship_down.get(node, 0.0) > now:
                    continue
                if self._ship_one(node, payload):
                    acked.add(node)
            if acked:
                break
            if attempt < defaults.REPL_SHIP_RETRIES:
                time.sleep(defaults.REPL_SHIP_RETRY_BASE_S * (2 ** attempt))
        if not acked:
            _REPL_SHIPS.inc(outcome="degraded")
        lag = self.log.last_lsn - max(self._acked.values(), default=0)
        _REPL_ACK_LAG.set(float(max(lag, 0)))

    def _ship_one(self, node: str, payload: dict) -> bool:
        t0 = time.time()
        try:
            resp = self.ship(node, payload)
        except Exception:
            self._mark_ship_down(node)
            _REPL_SHIP_SECONDS.observe(time.time() - t0)
            return False
        _REPL_SHIP_SECONDS.observe(time.time() - t0)
        if resp.get("fenced"):
            # the successor knows a higher epoch: WE are the zombie.
            # Nothing from this batch applies; the write futures fail
            # and the server layer flips this node to successor role.
            _REPL_SHIPS.inc(outcome="fenced")
            self.fenced = True
            raise ReplicationFenced(int(resp.get("epoch", -1)),
                                    resp.get("owner"), self.partition)
        if resp.get("need_from") is not None:
            # the successor missed ships (it was down while we proceeded
            # degraded): re-ship its whole missing tail once
            _REPL_SHIPS.inc(outcome="gap_refill")
            tail = self.log.tail(int(resp["need_from"]) - 1)
            refill = dict(payload)
            refill["from_lsn"] = tail[0]["lsn"] if tail \
                else payload["from_lsn"]
            refill["records"] = tail
            try:
                resp = self.ship(node, refill)
            except Exception:
                self._mark_ship_down(node)
                return False
        if resp.get("acked"):
            _REPL_SHIPS.inc(outcome="acked")
            self._ship_down.pop(node, None)
            self._acked[node] = int(resp.get("lsn", 0))
            return True
        return False

    def _mark_ship_down(self, node: str) -> None:
        self._ship_down[node] = (time.time()
                                 + defaults.FEDERATION_PEER_BACKOFF_S)
        _REPL_SHIPS.inc(outcome="failed")

    # --- successor side -----------------------------------------------------

    def accept_ship(self, epoch: int, from_lsn: int,
                    records: List[dict]) -> dict:
        """Successor intake for one shipped tail.  Stale epochs are
        fenced; a higher epoch is adopted (truncating any divergent
        local tail the fenced zombie had shipped us); a gap asks the
        primary to re-ship from our next lsn.  Records land in the LOG
        only — application waits for :meth:`promote` — except after a
        truncation, which forces a full rebuild (see :meth:`_rebuild`)
        because sqlite may hold effects of the records just dropped."""
        resp, rebuild = self._accept_ship_locked(epoch, from_lsn,
                                                 records)
        if rebuild:
            # outside _repl_lock: the rebuild runs on the writer
            # thread, whose _execute_batch takes the lock itself
            self._rebuild()
        return resp

    def _accept_ship_locked(self, epoch: int, from_lsn: int,
                            records: List[dict]):
        rebuild = False
        with self._repl_lock:
            if epoch < self.log.epoch:
                _REPL_FENCED.inc()
                return {"fenced": True, "epoch": self.log.epoch,
                        "owner": self.owner}, False
            if epoch > self.log.epoch:
                faults.crashpoint(_CP_REPL_APPEND_PRE)
                if self.log.last_lsn >= from_lsn:
                    self.log.truncate_after(int(from_lsn) - 1)
                    self.log.set_dirty(True)
                    rebuild = True
                self.log.set_epoch(epoch)
                faults.crashpoint(_CP_REPL_APPEND_POST)
                self.fenced = False
                _REPL_EPOCH.set(float(epoch),
                                partition=str(self.partition))
            if from_lsn > self.log.last_lsn + 1:
                return {"need_from": self.log.last_lsn + 1,
                        "epoch": self.log.epoch}, rebuild
            fresh = [r for r in records
                     if int(r["lsn"]) > self.log.last_lsn]
            if fresh:
                faults.crashpoint(_CP_REPL_APPEND_PRE)
                self.log.append(fresh)
                faults.crashpoint(_CP_REPL_APPEND_POST)
                _REPL_LOG_RECORDS.inc(float(len(fresh)), role="successor")
            return {"acked": True, "lsn": self.log.last_lsn,
                    "epoch": self.log.epoch}, rebuild

    def promote(self) -> int:
        """Assume primary role for this partition: bump the fencing
        epoch durably, then replay the unapplied log tail into sqlite.
        Idempotent under a crash at any point — the epoch bump replays
        (another +1 is harmless: epochs only need monotonicity), and
        the replay's applied-lsn cursor advances in the same transaction
        as the rows it applies."""
        t0 = time.time()
        with self._repl_lock:
            faults.crashpoint(_CP_REPL_PROMOTE_PRE)
            self.log.set_epoch(self.log.epoch + 1)
        self.replay()
        faults.crashpoint(_CP_REPL_PROMOTE_POST)
        with self._repl_lock:
            self.fenced = False
            self.owner = self.node_id
        _REPL_PROMOTES.inc()
        _REPL_PROMOTE_SECONDS.observe(time.time() - t0)
        _REPL_EPOCH.set(float(self.log.epoch),
                        partition=str(self.partition))
        return self.log.epoch

    def replay(self) -> int:
        """Apply every fully-durable log record past the applied-lsn
        cursor (one writer-thread transaction); returns records
        applied.  Running it twice is a no-op — the row-level-diff
        idempotence the fencing gate checks."""
        return self._run(self._replay_conn)

    def _rebuild(self) -> int:
        """Rebuild sqlite from the full log after a divergent-tail
        truncation.  A fenced zombie's degraded-mode writes were
        APPLIED locally (their futures resolved against this node's
        disk alone), so after the truncation drops those records the
        applied-lsn cursor lies: it counts lsns the log no longer
        holds, which would make replay silently skip the new primary's
        records at the same lsns.  Wiping the data tables and
        re-applying the whole log restores the invariant that sqlite
        is exactly the log prefix up to the cursor.  The dirty flag is
        cleared only after the rebuild transaction commits — a crash
        mid-rebuild re-runs it at reopen."""
        n = self._run(self._op_rebuild)
        self.log.set_dirty(False)
        return n

    def _op_rebuild(self, conn) -> int:
        for table in ("clients", "peer_backups", "snapshots",
                      "audit_reports", "repair_reports"):
            conn.execute("DELETE FROM " + table)
        for rec in self.log.records:
            self._apply_record(conn, rec)
        self._set_applied(conn, self.log.last_lsn)
        return len(self.log.records)

    def _replay_conn(self, conn) -> int:
        applied = self._op_applied_lsn(conn)
        tail = self.log.tail(applied)
        for rec in tail:
            self._apply_record(conn, rec)
        if tail:
            self._set_applied(conn, tail[-1]["lsn"])
        return len(tail)

    @staticmethod
    def _apply_record(conn, rec: dict) -> None:
        op = getattr(SqliteServerStore, "_op_" + rec["op"])
        args = decode_value(list(rec["args"]))
        if _REPL_WRITE_OPS.get(rec["op"]):
            args = args + [rec["ts"]]
        op(conn, *args)

    # --- the exactly-once cursor -------------------------------------------

    @staticmethod
    def _op_applied_lsn(conn) -> int:
        row = conn.execute(
            "SELECT value FROM metadata WHERE key = 'repl_applied_lsn'"
        ).fetchone()
        return int(row[0]) if row is not None else 0

    @staticmethod
    def _set_applied(conn, lsn: int) -> None:
        conn.execute(
            "INSERT INTO metadata (key, value) VALUES"
            " ('repl_applied_lsn', ?) ON CONFLICT(key)"
            " DO UPDATE SET value = excluded.value", (str(int(lsn)),))

    def applied_lsn(self) -> int:
        return self._run(self._op_applied_lsn)


class _ReplicatedAio:
    """``store.aio.<method>`` for :class:`ReplicatedServerStore`:
    locally owned partitions use the partition's own write-behind
    facade; foreign partitions forward to their owner."""

    def __init__(self, store: "ReplicatedServerStore"):
        self._store = store

    def __getattr__(self, name: str):
        if getattr(SqliteServerStore, "_op_" + name, None) is None:
            raise AttributeError(name)
        store = self._store

        async def call(*args):
            return await store._dispatch_async(name, args)

        call.__name__ = name
        return call


class ReplicatedServerStore(ServerStore):
    """Per-node replicated store: N :class:`_ReplPartitionStore` files
    under this node's OWN directory (nothing shared — node death is
    observable at the storage layer), with partition ownership decided
    by the ring and every write log-shipped to the partition's ring
    successors before its future resolves.

    Standalone (no federation) every partition is self-owned with an
    empty chain, and the store behaves exactly like
    :class:`PartitionedServerStore` — the conformance suite runs it
    that way.  Under federation the server layer installs the topology
    (:meth:`set_topology`), the sync ship hook, and the forward hooks
    for ops whose partition lives elsewhere; :meth:`promote` is the
    promote-on-death entry the probe loop calls.
    """

    _FAN_OUT = PartitionedServerStore._FAN_OUT

    def __init__(self, root, node_id: str = "n0",
                 partitions: Optional[int] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.node_id = str(node_id)
        self.write_behind = True
        n = max(1, int(partitions or defaults.SERVER_STORE_PARTITIONS))
        self.parts: List[_ReplPartitionStore] = [
            _ReplPartitionStore(str(self.root / f"part_{i:02d}.db"),
                                str(self.root / f"part_{i:02d}.log"),
                                i, self.node_id)
            for i in range(n)]
        #: partition -> owning node id; self-owns-all until the server
        #: layer installs the ring-derived topology
        self.owners: Dict[int, str] = {}
        for i, part in enumerate(self.parts):
            self.owners[i] = self.node_id
            part.owner = self.node_id
        #: forward hooks for ops on foreign-owned partitions, wired by
        #: the server layer: sync ``(owner, body) -> response`` and its
        #: async twin.  ``None`` = execute locally (standalone mode).
        self.forward_sync: Optional[Callable[[str, dict], dict]] = None
        self.forward_async = None

    # --- topology ----------------------------------------------------------

    def partition_index(self, pubkey: bytes) -> int:
        return ring_partition_of(pubkey, len(self.parts))

    def partition_for(self, pubkey: bytes) -> _ReplPartitionStore:
        return self.parts[self.partition_index(pubkey)]

    def set_topology(self, owners: Optional[Dict[int, str]] = None,
                     successors: Optional[Dict[int, List[str]]] = None,
                     ship: Optional[Callable[[str, dict], dict]] = None,
                     ) -> None:
        for i, part in enumerate(self.parts):
            if owners is not None and i in owners:
                self.owners[i] = owners[i]
                part.owner = owners[i]
            if successors is not None:
                part.successors = [n for n in successors.get(i, [])
                                   if n != self.node_id]
            if ship is not None:
                part.ship = ship

    def set_owner(self, partition: int, node_id: str) -> None:
        self.owners[int(partition)] = node_id
        self.parts[int(partition)].owner = node_id

    def promote(self, partition: int) -> int:
        epoch = self.parts[int(partition)].promote()
        self.set_owner(int(partition), self.node_id)
        return epoch

    def accept_ship(self, payload: dict) -> dict:
        part = self.parts[int(payload["partition"])]
        return part.accept_ship(int(payload["epoch"]),
                                int(payload["from_lsn"]),
                                list(payload.get("records") or []))

    def log_tail(self, partition: int, after_lsn: int) -> dict:
        """This node's log records past ``after_lsn`` for a partition —
        the promote-time reconciliation read (a sibling successor may
        hold acked records the promoting node never saw)."""
        part = self.parts[int(partition)]
        with part._repl_lock:
            return {"epoch": part.log.epoch,
                    "records": part.log.tail(int(after_lsn))}

    def execute_local(self, partition: int, name: str,
                      args: list) -> dict:
        """Serve one forwarded op on a LOCAL partition (the /repl/
        forward intake).  Never re-forwards — a stale owner map on the
        sender gets ``wrong_owner`` back and retries once toward the
        node named here."""
        i = int(partition)
        if getattr(SqliteServerStore, "_op_" + name, None) is None:
            raise ValueError(f"unknown op {name!r}")
        if self.owners.get(i) != self.node_id:
            _REPL_FORWARDS.inc(outcome="wrong_owner")
            return {"wrong_owner": self.owners.get(i)}
        result = getattr(self.parts[i], name)(*decode_value(list(args)))
        return {"result": encode_value(result)}

    @property
    def commit_threads(self) -> set:
        out: set = set()
        for p in self.parts:
            out |= p.commit_threads
        return out

    # --- dispatch ----------------------------------------------------------

    def _target_partitions(self, name: str, args) -> List[int]:
        if name in self._FAN_OUT:
            return list(range(len(self.parts)))
        if name == "reclaim_negotiation":
            idxs = {self.partition_index(args[0]),
                    self.partition_index(args[1])}
            return sorted(idxs)
        return [self.partition_index(args[0])]

    @staticmethod
    def _merge(name: str, results: List[Any]) -> Any:
        if name == "audit_failing_reporters":
            return sum(results)
        if name == "reclaim_negotiation":
            return sum(results)
        if name == "get_clients_storing_on":
            return PartitionedServerStore._merge_distinct(list(results))
        return results[0]

    def _forward_body(self, i: int, name: str, args) -> dict:
        return {"partition": i, "op": name,
                "args": encode_value(list(args))}

    def _dispatch_sync(self, name: str, args):
        if name == "schema_version":
            return self.parts[0].schema_version()
        out = []
        for i in self._target_partitions(name, args):
            if self.owners.get(i) == self.node_id \
                    or self.forward_sync is None:
                out.append(getattr(self.parts[i], name)(*args))
                continue
            resp = self.forward_sync(self.owners[i],
                                     self._forward_body(i, name, args))
            if resp.get("wrong_owner"):
                # stale owner map: adopt the correction, retry once
                self.set_owner(i, resp["wrong_owner"])
                if resp["wrong_owner"] == self.node_id:
                    out.append(getattr(self.parts[i], name)(*args))
                    continue
                resp = self.forward_sync(
                    self.owners[i], self._forward_body(i, name, args))
            _REPL_FORWARDS.inc(outcome="ok")
            out.append(decode_value(resp["result"]))
        if name in self._FAN_OUT or name == "reclaim_negotiation":
            return self._merge(name, out)
        return out[0]

    async def _dispatch_async(self, name: str, args):
        if name == "schema_version":
            return await self.parts[0].aio.schema_version()
        out = []
        for i in self._target_partitions(name, args):
            if self.owners.get(i) == self.node_id \
                    or self.forward_async is None:
                out.append(
                    await getattr(self.parts[i].aio, name)(*args))
                continue
            resp = await self.forward_async(
                self.owners[i], self._forward_body(i, name, args))
            if resp.get("wrong_owner"):
                self.set_owner(i, resp["wrong_owner"])
                if resp["wrong_owner"] == self.node_id:
                    out.append(
                        await getattr(self.parts[i].aio, name)(*args))
                    continue
                resp = await self.forward_async(
                    self.owners[i], self._forward_body(i, name, args))
            _REPL_FORWARDS.inc(outcome="ok")
            out.append(decode_value(resp["result"]))
        if name in self._FAN_OUT or name == "reclaim_negotiation":
            return self._merge(name, out)
        return out[0]

    @property
    def aio(self) -> _ReplicatedAio:
        return _ReplicatedAio(self)

    # --- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        for p in self.parts:
            p.flush()

    def close(self) -> None:
        for p in self.parts:
            p.close()

    # --- the ServerStore surface, routed ------------------------------------

    def schema_version(self) -> int:
        return self._dispatch_sync("schema_version", ())

    def register_client(self, pubkey: bytes) -> None:
        self._dispatch_sync("register_client", (pubkey,))

    def client_exists(self, pubkey: bytes) -> bool:
        return self._dispatch_sync("client_exists", (pubkey,))

    def client_update_logged_in(self, pubkey: bytes) -> None:
        self._dispatch_sync("client_update_logged_in", (pubkey,))

    def save_storage_negotiated(self, source: bytes, destination: bytes,
                                size: int) -> None:
        self._dispatch_sync("save_storage_negotiated",
                            (source, destination, size))

    def delete_storage_negotiated(self, source: bytes, destination: bytes,
                                  size: int) -> None:
        self._dispatch_sync("delete_storage_negotiated",
                            (source, destination, size))

    def save_snapshot(self, pubkey: bytes, snapshot_hash: bytes) -> None:
        self._dispatch_sync("save_snapshot", (pubkey, snapshot_hash))

    def get_latest_client_snapshot(self, pubkey: bytes) -> Optional[bytes]:
        return self._dispatch_sync("get_latest_client_snapshot", (pubkey,))

    def get_client_negotiated_peers(self, pubkey: bytes) -> list:
        return self._dispatch_sync("get_client_negotiated_peers", (pubkey,))

    def get_clients_storing_on(self, pubkey: bytes) -> list:
        return self._dispatch_sync("get_clients_storing_on", (pubkey,))

    def save_audit_report(self, reporter: bytes, peer: bytes, passed: bool,
                          detail: str) -> None:
        self._dispatch_sync("save_audit_report",
                            (reporter, peer, passed, detail))

    def save_repair_report(self, reporter: bytes, peer: bytes,
                           packfiles_lost: int, bytes_lost: int,
                           bytes_replaced: int) -> None:
        self._dispatch_sync("save_repair_report",
                            (reporter, peer, packfiles_lost, bytes_lost,
                             bytes_replaced))

    def reclaim_negotiation(self, client: bytes, peer: bytes) -> int:
        return self._dispatch_sync("reclaim_negotiation", (client, peer))

    def audit_failing_reporters(self, peer: bytes, window_s: float) -> int:
        return self._dispatch_sync("audit_failing_reporters",
                                   (peer, window_s))
