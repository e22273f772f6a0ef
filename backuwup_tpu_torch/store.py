"""Local client state store: identity, backup config, peer ledger, event log.

Counterpart of ``backuwup_tpu/store.py``, copied so that the port imports
nothing of the JAX package.  The schema, the SQL and the locking are the
reference's, so each package opens a database the other wrote.

Re-designs the reference's SQLite config layer (``client/src/config/mod.rs``,
``identity.rs``, ``backup.rs``, ``peers.rs``, ``log.rs``) on the stdlib
``sqlite3`` module.  Same responsibilities:

* ``config`` table — typed KV: root secret, auth token, obfuscation key,
  initialized flag, backup path, highest-sent-index watermark
  (``config/identity.rs:85-180``, ``config/backup.rs:32-98``).
* ``peers`` table — storage-accounting ledger per peer:
  transmitted/received/negotiated byte counters, first/last seen
  (``config/peers.rs:12-19``); ``find_peers_with_storage`` orders by free
  space like ``peers.rs:176-193``.
* ``log`` table — append-only event log doubling as restore rate-limiter and
  backup size-estimator source (``config/log.rs:83-160``).

Directory resolution honors ``CONFIG_DIR`` / ``DATA_DIR`` env vars — the
test seam the reference uses to run N clients on one machine
(``config/mod.rs:90-103``, SURVEY.md §4).
"""

from __future__ import annotations

import json
import math
import os
import sqlite3
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from . import defaults

_SCHEMA = """
CREATE TABLE IF NOT EXISTS config (
    key TEXT PRIMARY KEY,
    value BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS peers (
    pubkey BLOB PRIMARY KEY,
    bytes_transmitted INTEGER NOT NULL DEFAULT 0,
    bytes_received INTEGER NOT NULL DEFAULT 0,
    bytes_negotiated INTEGER NOT NULL DEFAULT 0,
    first_seen REAL NOT NULL,
    last_seen REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    timestamp REAL NOT NULL,
    event TEXT NOT NULL,
    data TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS placements (
    packfile_id BLOB NOT NULL,
    peer BLOB NOT NULL,
    size INTEGER NOT NULL,
    sent_at REAL NOT NULL,
    shard_index INTEGER NOT NULL DEFAULT -1,
    PRIMARY KEY (packfile_id, peer)
);
CREATE TABLE IF NOT EXISTS audit_ledger (
    peer BLOB PRIMARY KEY,
    passes INTEGER NOT NULL DEFAULT 0,
    failures INTEGER NOT NULL DEFAULT 0,
    misses INTEGER NOT NULL DEFAULT 0,
    consecutive_failures INTEGER NOT NULL DEFAULT 0,
    consecutive_misses INTEGER NOT NULL DEFAULT 0,
    demoted INTEGER NOT NULL DEFAULT 0,
    last_result TEXT NOT NULL DEFAULT '',
    last_audit REAL NOT NULL DEFAULT 0,
    next_due REAL NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS peer_stats (
    peer BLOB PRIMARY KEY,
    throughput_bps REAL NOT NULL DEFAULT 0,
    latency_s REAL NOT NULL DEFAULT 0,
    success REAL NOT NULL DEFAULT 1,
    samples INTEGER NOT NULL DEFAULT 0,
    updated REAL NOT NULL DEFAULT 0,
    placement_demoted INTEGER NOT NULL DEFAULT 0,
    placement_demoted_at REAL NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS snapshots (
    hash BLOB PRIMARY KEY,
    parent BLOB,
    created_at REAL NOT NULL,
    size INTEGER NOT NULL DEFAULT 0,
    pruned_at REAL NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS snapshot_blobs (
    snapshot_hash BLOB NOT NULL,
    blob_hash BLOB NOT NULL,
    size INTEGER NOT NULL,
    PRIMARY KEY (snapshot_hash, blob_hash)
);
CREATE TABLE IF NOT EXISTS reclaim_backlog (
    file_id BLOB NOT NULL,
    peer BLOB NOT NULL,
    kind INTEGER NOT NULL,
    size INTEGER NOT NULL DEFAULT 0,
    queued_at REAL NOT NULL,
    PRIMARY KEY (file_id, peer)
);
"""

EVENT_BACKUP = "backup"
EVENT_RESTORE_REQUEST = "restore_request"
EVENT_REPAIR = "repair"
EVENT_GC = "gc"


def config_dir() -> Path:
    d = os.environ.get("CONFIG_DIR")
    return Path(d) if d else Path.home() / ".backuwup" / "config"


def data_dir() -> Path:
    d = os.environ.get("DATA_DIR")
    return Path(d) if d else Path.home() / ".backuwup" / "data"


@dataclass(frozen=True)
class AuditState:
    """One peer's row in the audit ledger (no reference equivalent)."""

    peer: bytes
    passes: int = 0
    failures: int = 0
    misses: int = 0
    consecutive_failures: int = 0
    consecutive_misses: int = 0
    demoted: bool = False
    last_result: str = ""
    last_audit: float = 0.0
    next_due: float = 0.0


@dataclass(frozen=True)
class PeerStatsRow:
    """One peer's persisted transfer estimators (net/peer_stats.py; no
    reference equivalent).  EWMA state, not raw telemetry — the
    histograms live in the metrics registry and reset with the process;
    this row is what survives a client restart."""

    peer: bytes
    throughput_bps: float = 0.0
    latency_s: float = 0.0
    success: float = 1.0
    samples: int = 0
    updated: float = 0.0
    #: placement demotion — distinct from audit demotion (audit_ledger):
    #: the peer is measured too slow/flaky to receive NEW placements, but
    #: its held data still counts and it recovers after probation or a
    #: run of successes.
    placement_demoted: bool = False
    placement_demoted_at: float = 0.0


@dataclass(frozen=True)
class SnapshotRow:
    """One snapshot's lineage row (docs/lifecycle.md; no reference
    equivalent).  ``pruned_at`` > 0 means retention marked it dead —
    pruning never touches data, only this flag; reclaiming the bytes is
    GC's job."""

    hash: bytes
    parent: Optional[bytes]
    created_at: float
    size: int = 0
    pruned_at: float = 0.0

    @property
    def retained(self) -> bool:
        return self.pruned_at == 0.0


@dataclass(frozen=True)
class PeerInfo:
    """config/peers.rs:12-19."""

    pubkey: bytes
    bytes_transmitted: int
    bytes_received: int
    bytes_negotiated: int
    first_seen: float
    last_seen: float

    @property
    def free_storage(self) -> int:
        return max(0, self.bytes_negotiated - self.bytes_transmitted)


class Store:
    """One client's persistent local state."""

    def __init__(self, directory: Optional[Path] = None,
                 data_base: Optional[Path] = None):
        self.dir = Path(directory) if directory else config_dir()
        self.dir.mkdir(parents=True, exist_ok=True)
        # data dir is per-store so N clients can share a process (the
        # reference separates clients per-process via DATA_DIR; this is the
        # in-process generalization of that seam)
        self.data_base = Path(data_base) if data_base else data_dir()
        self._lock = threading.RLock()
        self._db = sqlite3.connect(self.dir / "config.db",
                                   check_same_thread=False)
        # same crash discipline as the server DB (net/server.py): WAL keeps
        # a mid-transaction process death from corrupting placements/peer
        # state; NORMAL syncs the WAL at checkpoint, plenty for a client
        # whose DB can be re-derived from the server plus its own disk
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.executescript(_SCHEMA)
        # erasure-era column on pre-existing databases; -1 = whole packfile
        # (the CREATE above already carries it for fresh stores)
        try:
            self._db.execute(
                "ALTER TABLE placements ADD COLUMN"
                " shard_index INTEGER NOT NULL DEFAULT -1")
        except sqlite3.OperationalError:
            pass  # already present
        # WAN-era placement-demotion columns on pre-existing databases
        for clause in ("placement_demoted INTEGER NOT NULL DEFAULT 0",
                       "placement_demoted_at REAL NOT NULL DEFAULT 0"):
            try:
                self._db.execute(
                    f"ALTER TABLE peer_stats ADD COLUMN {clause}")
            except sqlite3.OperationalError:
                pass  # already present
        self._db.commit()

    def close(self) -> None:
        self._db.close()

    # --- generic KV -------------------------------------------------------

    def _get(self, key: str) -> Optional[bytes]:
        with self._lock:
            row = self._db.execute(
                "SELECT value FROM config WHERE key = ?", (key,)).fetchone()
        return None if row is None else bytes(row[0])

    def _set(self, key: str, value: Optional[bytes]) -> None:
        with self._lock:
            if value is None:
                self._db.execute("DELETE FROM config WHERE key = ?", (key,))
            else:
                self._db.execute(
                    "INSERT INTO config (key, value) VALUES (?, ?) "
                    "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
                    (key, bytes(value)))
            self._db.commit()

    # --- identity (config/identity.rs:85-180) -----------------------------

    def get_root_secret(self) -> Optional[bytes]:
        return self._get("root_secret")

    def set_root_secret(self, secret: bytes) -> None:
        self._set("root_secret", secret)

    def get_auth_token(self) -> Optional[bytes]:
        return self._get("auth_token")

    def set_auth_token(self, token: Optional[bytes]) -> None:
        self._set("auth_token", token)

    def get_obfuscation_key(self) -> Optional[bytes]:
        return self._get("obfuscation_key")

    def set_obfuscation_key(self, key: bytes) -> None:
        if len(key) != 4:
            raise ValueError("obfuscation key must be 4 bytes")
        self._set("obfuscation_key", key)

    def is_initialized(self) -> bool:
        return self._get("initialized") == b"1"

    def set_initialized(self) -> None:
        self._set("initialized", b"1")

    # --- backup config (config/backup.rs) ---------------------------------

    def get_backup_path(self) -> Optional[str]:
        v = self._get("backup_path")
        return None if v is None else v.decode()

    def set_backup_path(self, path: str) -> None:
        self._set("backup_path", path.encode())

    def get_highest_sent_index(self) -> int:
        """Resume-safe index watermark (config/backup.rs:80-98)."""
        v = self._get("highest_sent_index")
        return -1 if v is None else int(v)

    def set_highest_sent_index(self, idx: int) -> None:
        # Monotonic: the watermark means "every index file <= idx was acked",
        # so it must never move backwards (a regression would re-send files
        # the peer's writer refuses to overwrite).
        self._set("highest_sent_index",
                  str(max(int(idx), self.get_highest_sent_index())).encode())

    def packfile_dir(self) -> Path:
        d = self.data_base / "packfiles"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def index_dir(self) -> Path:
        d = self.data_base / "index"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def dedup_cold_dir(self) -> Path:
        """Cold-tier fingerprint runs (dedupstore.ColdFingerprintStore)."""
        d = self.data_base / "dedup_cold"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def received_dir(self, peer_id: bytes) -> Path:
        d = self.data_base / "received_packfiles" / bytes(peer_id).hex()
        d.mkdir(parents=True, exist_ok=True)
        return d

    def restore_dir(self) -> Path:
        d = self.data_base / "restore_packfiles"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def challenge_dir(self) -> Path:
        """Encrypted per-packfile audit challenge tables (docs/audit.md)."""
        d = self.data_base / "challenges"
        d.mkdir(parents=True, exist_ok=True)
        return d

    # --- peers ledger (config/peers.rs) ------------------------------------

    def add_peer_negotiated(self, pubkey: bytes, amount: int,
                            now: Optional[float] = None) -> None:
        """Upsert-increment negotiated storage (peers.rs:110-123)."""
        self._bump_peer(pubkey, "bytes_negotiated", amount, now)

    def add_peer_transmitted(self, pubkey: bytes, amount: int) -> None:
        self._bump_peer(pubkey, "bytes_transmitted", amount)

    def add_peer_received(self, pubkey: bytes, amount: int) -> None:
        self._bump_peer(pubkey, "bytes_received", amount)

    def credit_peer_transmitted(self, pubkey: bytes, amount: int) -> None:
        """Clamped decrement after a holder acks a RECLAIM: the freed
        bytes count against ``bytes_transmitted`` again as free storage.
        Clamped at zero — a double-delivered ack must not mint quota."""
        self._credit_peer(pubkey, "bytes_transmitted", amount)

    def credit_peer_received(self, pubkey: bytes, amount: int) -> None:
        """Holder-side quota credit when serving a RECLAIM: the deleted
        packfiles stop counting against the requester's received quota."""
        self._credit_peer(pubkey, "bytes_received", amount)

    def _credit_peer(self, pubkey: bytes, column: str, amount: int) -> None:
        with self._lock:
            self._db.execute(
                f"UPDATE peers SET {column} = MAX(0, {column} - ?),"
                " last_seen = ? WHERE pubkey = ?",
                (int(amount), time.time(), bytes(pubkey)))
            self._db.commit()

    def _bump_peer(self, pubkey: bytes, column: str, amount: int,
                   now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            cur = self._db.execute(
                f"UPDATE peers SET {column} = {column} + ?, last_seen = ?"
                " WHERE pubkey = ?", (int(amount), now, bytes(pubkey)))
            if cur.rowcount == 0:
                self._db.execute(
                    f"INSERT INTO peers (pubkey, {column}, first_seen, last_seen)"
                    " VALUES (?, ?, ?, ?)",
                    (bytes(pubkey), int(amount), now, now))
            self._db.commit()

    def get_peer(self, pubkey: bytes) -> Optional[PeerInfo]:
        with self._lock:
            row = self._db.execute(
                "SELECT pubkey, bytes_transmitted, bytes_received,"
                " bytes_negotiated, first_seen, last_seen FROM peers"
                " WHERE pubkey = ?", (bytes(pubkey),)).fetchone()
        return None if row is None else PeerInfo(bytes(row[0]), *row[1:])

    def list_peers(self) -> list:
        with self._lock:
            rows = self._db.execute(
                "SELECT pubkey, bytes_transmitted, bytes_received,"
                " bytes_negotiated, first_seen, last_seen FROM peers").fetchall()
        return [PeerInfo(bytes(r[0]), *r[1:]) for r in rows]

    def find_peers_with_storage(self, exclude=()) -> list:
        """Peers ordered by measured capacity (throughput × success from
        the persisted EWMA estimators), free storage as tiebreak — bytes
        go where they are most likely to land fast (peers.rs:176-193
        ordered by free space alone).  Two exclusion sets apply: peers the
        audit ledger demoted (proven to drop data — never again) and
        placement-demoted peers (measured too slow/flaky — sit out until
        probation expires or successes recover them).  ``exclude`` adds
        caller-side exclusions (the repair round must not re-place data on
        the very peers it is repairing away from).
        """
        avoid = (self.demoted_peers() | self.placement_demoted_peers()
                 | {bytes(p) for p in exclude})
        peers = [p for p in self.list_peers()
                 if p.free_storage > 0 and p.pubkey not in avoid]
        stats = {s.peer: s for s in self.all_peer_stats()}

        def bucket(p: "PeerInfo") -> int:
            # log2 buckets keep the ordering deterministic under EWMA
            # jitter: a 2x capacity gap reorders, a 3% one does not.
            # Unmeasured peers score a neutral floor so newcomers are
            # neither starved nor preferred over proven-fast peers.
            st = stats.get(p.pubkey)
            if st is None or st.samples < defaults.PLACEMENT_MIN_SAMPLES:
                score = float(defaults.PLACEMENT_NEUTRAL_SCORE_BPS)
            else:
                score = st.throughput_bps * max(st.success, 0.0)
            return int(math.log2(max(score, 1.0)))

        # deterministic: capacity bucket desc, free space desc, pubkey —
        # shard placement must be reproducible under the seeded fault plane
        peers.sort(key=lambda p: (-bucket(p), -p.free_storage, p.pubkey))
        return peers

    # --- packfile placements (verifier's who-holds-what map) ----------------

    def record_placement(self, packfile_id: bytes, peer: bytes, size: int,
                         now: Optional[float] = None,
                         shard_index: int = -1) -> None:
        """``shard_index`` -1 = the peer holds the whole packfile; >= 0 =
        it holds that one erasure shard of the stripe.  The (packfile_id,
        peer) key enforces one shard per peer per stripe."""
        now = time.time() if now is None else now
        with self._lock:
            self._db.execute(
                "INSERT INTO placements"
                " (packfile_id, peer, size, sent_at, shard_index)"
                " VALUES (?, ?, ?, ?, ?)"
                " ON CONFLICT(packfile_id, peer) DO NOTHING",
                (bytes(packfile_id), bytes(peer), int(size), now,
                 int(shard_index)))
            self._db.commit()

    def placements_for_peer(self, peer: bytes) -> list:
        """[(packfile_id, size)] held by ``peer``, oldest placement first."""
        with self._lock:
            rows = self._db.execute(
                "SELECT packfile_id, size FROM placements WHERE peer = ?"
                " ORDER BY sent_at", (bytes(peer),)).fetchall()
        return [(bytes(r[0]), int(r[1])) for r in rows]

    def shard_placements_for_peer(self, peer: bytes) -> list:
        """[(packfile_id, size, shard_index)] held by ``peer``, oldest
        first; shard_index -1 means the whole packfile."""
        with self._lock:
            rows = self._db.execute(
                "SELECT packfile_id, size, shard_index FROM placements"
                " WHERE peer = ? ORDER BY sent_at",
                (bytes(peer),)).fetchall()
        return [(bytes(r[0]), int(r[1]), int(r[2])) for r in rows]

    def shards_for_packfile(self, packfile_id: bytes) -> list:
        """[(peer, shard_index)] across the stripe (or [(peer, -1)] rows
        for whole-packfile replication)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT peer, shard_index FROM placements"
                " WHERE packfile_id = ?", (bytes(packfile_id),)).fetchall()
        return [(bytes(r[0]), int(r[1])) for r in rows]

    def placements_for_packfile(self, packfile_id: bytes) -> list:
        """[(peer, size, shard_index)] — GC's retire/reclaim walk needs
        the per-row byte sizes alongside the stripe geometry."""
        with self._lock:
            rows = self._db.execute(
                "SELECT peer, size, shard_index FROM placements"
                " WHERE packfile_id = ?", (bytes(packfile_id),)).fetchall()
        return [(bytes(r[0]), int(r[1]), int(r[2])) for r in rows]

    def retire_placement(self, packfile_id: bytes, peer: bytes) -> int:
        """Drop one (packfile, peer) placement row — sourceless shard
        repair retires exactly the lost shard rows it re-homed."""
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM placements WHERE packfile_id = ? AND peer = ?",
                (bytes(packfile_id), bytes(peer)))
            self._db.commit()
        return cur.rowcount

    def all_placements(self) -> list:
        """Every placement row as ``(packfile_id, peer, size,
        shard_index, sent_at)`` — the invariant monitor's one-query
        sweep over the who-holds-what map (obs/invariants.py)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT packfile_id, peer, size, shard_index, sent_at"
                " FROM placements").fetchall()
        return [(bytes(r[0]), bytes(r[1]), int(r[2]), int(r[3]),
                 float(r[4])) for r in rows]

    def peers_with_placements(self) -> list:
        with self._lock:
            rows = self._db.execute(
                "SELECT DISTINCT peer FROM placements").fetchall()
        return [bytes(r[0]) for r in rows]

    def peers_for_packfile(self, packfile_id: bytes) -> list:
        """Every peer recorded as holding ``packfile_id`` — a packfile is
        orphaned only when ALL of its placements are on lost peers."""
        with self._lock:
            rows = self._db.execute(
                "SELECT peer FROM placements WHERE packfile_id = ?",
                (bytes(packfile_id),)).fetchall()
        return [bytes(r[0]) for r in rows]

    def retire_placements(self, peer: bytes) -> int:
        """Drop every placement row for a lost peer once repair has
        re-homed (or written off) its packfiles; returns rows removed."""
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM placements WHERE peer = ?", (bytes(peer),))
            self._db.commit()
        return cur.rowcount

    # --- snapshot lineage + retention (docs/lifecycle.md) -------------------

    def record_snapshot(self, snapshot_hash: bytes, parent: Optional[bytes],
                        size: int, blobs, now: Optional[float] = None) -> None:
        """One transaction commits the lineage row AND its blob manifest
        (``blobs`` iterates (blob_hash, size) for every blob the snapshot
        references, duplicates included) — GC's mark phase is a local
        join against these manifests, so a snapshot must never exist
        without one (that is the legacy-store guard's trigger)."""
        now = time.time() if now is None else now
        with self._lock:
            self._db.execute(
                "INSERT INTO snapshots (hash, parent, created_at, size)"
                " VALUES (?, ?, ?, ?) ON CONFLICT(hash) DO UPDATE SET"
                " pruned_at = 0",
                (bytes(snapshot_hash),
                 None if parent is None else bytes(parent),
                 now, int(size)))
            self._db.executemany(
                "INSERT INTO snapshot_blobs (snapshot_hash, blob_hash, size)"
                " VALUES (?, ?, ?)"
                " ON CONFLICT(snapshot_hash, blob_hash) DO NOTHING",
                [(bytes(snapshot_hash), bytes(h), int(s))
                 for h, s in blobs])
            self._db.commit()

    def get_snapshot(self, snapshot_hash: bytes) -> Optional["SnapshotRow"]:
        with self._lock:
            row = self._db.execute(
                "SELECT hash, parent, created_at, size, pruned_at"
                " FROM snapshots WHERE hash = ?",
                (bytes(snapshot_hash),)).fetchone()
        if row is None:
            return None
        return SnapshotRow(bytes(row[0]),
                           None if row[1] is None else bytes(row[1]),
                           float(row[2]), int(row[3]), float(row[4]))

    def list_snapshots(self) -> list:
        """Every lineage row (pruned included), oldest first."""
        with self._lock:
            rows = self._db.execute(
                "SELECT hash, parent, created_at, size, pruned_at"
                " FROM snapshots ORDER BY created_at, hash").fetchall()
        return [SnapshotRow(bytes(r[0]),
                            None if r[1] is None else bytes(r[1]),
                            float(r[2]), int(r[3]), float(r[4]))
                for r in rows]

    def retained_snapshots(self) -> list:
        return [s for s in self.list_snapshots() if s.retained]

    def latest_snapshot(self) -> Optional["SnapshotRow"]:
        """Most recent RETAINED snapshot — the parent link for the next
        backup and the one snapshot retention may never prune."""
        retained = self.retained_snapshots()
        return retained[-1] if retained else None

    def prune_snapshots(self, hashes, now: Optional[float] = None) -> int:
        """Mark snapshots dead.  Never touches data — the blobs stay
        until GC proves nothing retained references them."""
        now = time.time() if now is None else now
        with self._lock:
            cur = self._db.executemany(
                "UPDATE snapshots SET pruned_at = ?"
                " WHERE hash = ? AND pruned_at = 0",
                [(now, bytes(h)) for h in hashes])
            self._db.commit()
        return cur.rowcount

    def get_retention_policy(self) -> Optional[str]:
        v = self._get("retention_policy")
        return None if v is None else v.decode()

    def set_retention_policy(self, policy: Optional[str]) -> None:
        self._set("retention_policy",
                  None if policy is None else policy.encode())

    def apply_retention(self, policy: Optional[str] = None,
                        now: Optional[float] = None) -> list:
        """Compute and mark the prune set under the named policy
        (comma-separated ``keep-last:N`` / ``keep-daily:N`` rules; a
        snapshot kept by ANY rule is retained).  The newest retained
        snapshot is always kept regardless of policy — retention must
        never walk the store back past the latest restorable state.
        Returns the pruned hashes."""
        policy = self.get_retention_policy() if policy is None else policy
        if not policy or policy.strip() == "keep-all":
            return []
        snaps = self.retained_snapshots()
        snaps.reverse()  # newest first
        if not snaps:
            return []
        keep = {snaps[0].hash}
        for rule in policy.split(","):
            rule = rule.strip()
            if not rule:
                continue
            name, _, arg = rule.partition(":")
            try:
                n = int(arg)
            except ValueError:
                raise ValueError(f"bad retention rule {rule!r}")
            if name == "keep-last":
                keep.update(s.hash for s in snaps[:n])
            elif name == "keep-daily":
                # newest snapshot per UTC day, for the N newest days
                days: dict = {}
                for s in snaps:
                    days.setdefault(int(s.created_at // 86400), s.hash)
                for day in sorted(days, reverse=True)[:n]:
                    keep.add(days[day])
            else:
                raise ValueError(f"unknown retention rule {rule!r}")
        prune = [s.hash for s in snaps if s.hash not in keep]
        if prune:
            self.prune_snapshots(prune, now=now)
        return prune

    def live_blobs(self) -> dict:
        """blob_hash -> size over every blob some RETAINED snapshot's
        manifest references — GC's mark phase in one query."""
        with self._lock:
            rows = self._db.execute(
                "SELECT sb.blob_hash, MAX(sb.size) FROM snapshot_blobs sb"
                " JOIN snapshots s ON s.hash = sb.snapshot_hash"
                " WHERE s.pruned_at = 0 GROUP BY sb.blob_hash").fetchall()
        return {bytes(r[0]): int(r[1]) for r in rows}

    def manifest_blobs(self) -> dict:
        """blob_hash -> size over EVERY manifest row, pruned snapshots
        included — GC's occupancy denominator (a packfile's total known
        payload, live or dead)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT blob_hash, MAX(size) FROM snapshot_blobs"
                " GROUP BY blob_hash").fetchall()
        return {bytes(r[0]): int(r[1]) for r in rows}

    def snapshots_without_manifest(self) -> list:
        """Retained snapshots with NO manifest rows — pre-lifecycle
        backups GC cannot reason about, so it must refuse to collect."""
        with self._lock:
            rows = self._db.execute(
                "SELECT s.hash FROM snapshots s WHERE s.pruned_at = 0"
                " AND NOT EXISTS (SELECT 1 FROM snapshot_blobs sb"
                " WHERE sb.snapshot_hash = s.hash)").fetchall()
        return [bytes(r[0]) for r in rows]

    def drop_pruned_manifests(self) -> int:
        """Delete manifest rows belonging to pruned snapshots (the
        lineage tombstone row itself stays); returns rows dropped."""
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM snapshot_blobs WHERE snapshot_hash IN"
                " (SELECT hash FROM snapshots WHERE pruned_at > 0)")
            self._db.commit()
        return cur.rowcount

    # --- GC run state (crash roll-forward; docs/lifecycle.md) ---------------

    def get_gc_state(self) -> Optional[dict]:
        v = self._get("gc_state")
        return None if v is None else json.loads(v)

    def set_gc_state(self, state: Optional[dict]) -> None:
        self._set("gc_state",
                  None if state is None
                  else json.dumps(state, sort_keys=True).encode())

    # --- reclaim backlog (make-before-break's best-effort tail) -------------

    def queue_reclaim(self, file_id: bytes, peer: bytes, kind: int,
                      size: int, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            self._db.execute(
                "INSERT INTO reclaim_backlog"
                " (file_id, peer, kind, size, queued_at)"
                " VALUES (?, ?, ?, ?, ?)"
                " ON CONFLICT(file_id, peer) DO NOTHING",
                (bytes(file_id), bytes(peer), int(kind), int(size), now))
            self._db.commit()

    def reclaim_backlog(self) -> list:
        """[(file_id, peer, kind, size)], oldest queued first."""
        with self._lock:
            rows = self._db.execute(
                "SELECT file_id, peer, kind, size FROM reclaim_backlog"
                " ORDER BY queued_at, file_id").fetchall()
        return [(bytes(r[0]), bytes(r[1]), int(r[2]), int(r[3]))
                for r in rows]

    def clear_reclaim(self, file_id: bytes, peer: bytes) -> int:
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM reclaim_backlog"
                " WHERE file_id = ? AND peer = ?",
                (bytes(file_id), bytes(peer)))
            self._db.commit()
        return cur.rowcount

    # --- audit ledger (docs/audit.md; no reference equivalent) --------------

    def get_audit_state(self, peer: bytes) -> "AuditState":
        with self._lock:
            row = self._db.execute(
                "SELECT peer, passes, failures, misses, consecutive_failures,"
                " consecutive_misses, demoted, last_result, last_audit,"
                " next_due FROM audit_ledger WHERE peer = ?",
                (bytes(peer),)).fetchone()
        if row is None:
            return AuditState(peer=bytes(peer))
        return AuditState(bytes(row[0]), *row[1:6], bool(row[6]), *row[7:])

    def put_audit_state(self, state: "AuditState") -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO audit_ledger (peer, passes, failures, misses,"
                " consecutive_failures, consecutive_misses, demoted,"
                " last_result, last_audit, next_due)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)"
                " ON CONFLICT(peer) DO UPDATE SET"
                " passes = excluded.passes, failures = excluded.failures,"
                " misses = excluded.misses,"
                " consecutive_failures = excluded.consecutive_failures,"
                " consecutive_misses = excluded.consecutive_misses,"
                " demoted = excluded.demoted,"
                " last_result = excluded.last_result,"
                " last_audit = excluded.last_audit,"
                " next_due = excluded.next_due",
                (state.peer, state.passes, state.failures, state.misses,
                 state.consecutive_failures, state.consecutive_misses,
                 int(state.demoted), state.last_result, state.last_audit,
                 state.next_due))
            self._db.commit()

    def demoted_peers(self) -> set:
        with self._lock:
            rows = self._db.execute(
                "SELECT peer FROM audit_ledger WHERE demoted = 1").fetchall()
        return {bytes(r[0]) for r in rows}

    def audit_due_peers(self, now: Optional[float] = None) -> list:
        """Peers holding placements whose next audit is due (next_due <=
        now), never-audited peers (no ledger row) first."""
        now = time.time() if now is None else now
        due = []
        for peer in self.peers_with_placements():
            st = self.get_audit_state(peer)
            if st.next_due <= now:
                due.append((st.next_due, peer))
        due.sort(key=lambda t: t[0])
        return [p for _, p in due]

    def mark_audit_due(self, peer: bytes,
                       now: Optional[float] = None) -> None:
        """Pull a peer's next audit forward to *now* (AuditDue push)."""
        now = time.time() if now is None else now
        st = self.get_audit_state(peer)
        if st.next_due > now:
            self.put_audit_state(
                AuditState(st.peer, st.passes, st.failures, st.misses,
                           st.consecutive_failures, st.consecutive_misses,
                           st.demoted, st.last_result, st.last_audit, now))

    # --- per-peer transfer estimators (net/peer_stats.py) -------------------

    def get_peer_stats(self, peer: bytes) -> Optional["PeerStatsRow"]:
        with self._lock:
            row = self._db.execute(
                "SELECT peer, throughput_bps, latency_s, success, samples,"
                " updated, placement_demoted, placement_demoted_at"
                " FROM peer_stats WHERE peer = ?",
                (bytes(peer),)).fetchone()
        if row is None:
            return None
        return PeerStatsRow(bytes(row[0]), *row[1:6], bool(row[6]), row[7])

    def put_peer_stats(self, row: "PeerStatsRow") -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO peer_stats (peer, throughput_bps, latency_s,"
                " success, samples, updated) VALUES (?, ?, ?, ?, ?, ?)"
                " ON CONFLICT(peer) DO UPDATE SET"
                " throughput_bps = excluded.throughput_bps,"
                " latency_s = excluded.latency_s,"
                " success = excluded.success,"
                " samples = excluded.samples,"
                " updated = excluded.updated",
                (bytes(row.peer), float(row.throughput_bps),
                 float(row.latency_s), float(row.success),
                 int(row.samples), float(row.updated)))
            self._db.commit()

    def all_peer_stats(self) -> list:
        with self._lock:
            rows = self._db.execute(
                "SELECT peer, throughput_bps, latency_s, success, samples,"
                " updated, placement_demoted, placement_demoted_at"
                " FROM peer_stats").fetchall()
        return [PeerStatsRow(bytes(r[0]), *r[1:6], bool(r[6]), r[7])
                for r in rows]

    def set_placement_demoted(self, peer: bytes, demoted: bool,
                              now: Optional[float] = None) -> None:
        """Flip a peer's placement-demotion flag (distinct from the audit
        ledger's demotion: this one is about measured capacity, not proven
        data loss, and is recoverable)."""
        now = time.time() if now is None else now
        with self._lock:
            cur = self._db.execute(
                "UPDATE peer_stats SET placement_demoted = ?,"
                " placement_demoted_at = ? WHERE peer = ?",
                (int(demoted), now if demoted else 0.0, bytes(peer)))
            if cur.rowcount == 0:
                self._db.execute(
                    "INSERT INTO peer_stats (peer, placement_demoted,"
                    " placement_demoted_at, updated) VALUES (?, ?, ?, ?)",
                    (bytes(peer), int(demoted),
                     now if demoted else 0.0, now))
            self._db.commit()

    def placement_demoted_peers(self, now: Optional[float] = None) -> set:
        """Peers currently placement-demoted.  Probation is lazy: a row
        demoted longer than ``PLACEMENT_PROBATION_S`` ago is cleared here
        — the peer gets another chance to prove itself."""
        now = time.time() if now is None else now
        cutoff = now - defaults.PLACEMENT_PROBATION_S
        with self._lock:
            self._db.execute(
                "UPDATE peer_stats SET placement_demoted = 0,"
                " placement_demoted_at = 0 WHERE placement_demoted = 1"
                " AND placement_demoted_at <= ?", (cutoff,))
            self._db.commit()
            rows = self._db.execute(
                "SELECT peer FROM peer_stats"
                " WHERE placement_demoted = 1").fetchall()
        return {bytes(r[0]) for r in rows}

    # --- audit challenge cursor (single-use table entries) ------------------

    def get_audit_cursor(self, packfile_id: bytes) -> int:
        v = self._get(f"audit_cursor:{bytes(packfile_id).hex()}")
        return 0 if v is None else int(v)

    def set_audit_cursor(self, packfile_id: bytes, value: int) -> None:
        self._set(f"audit_cursor:{bytes(packfile_id).hex()}",
                  str(int(value)).encode())

    # --- event log (config/log.rs) -----------------------------------------

    def add_event(self, event: str, data: dict,
                  now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            self._db.execute(
                "INSERT INTO log (timestamp, event, data) VALUES (?, ?, ?)",
                (now, event, json.dumps(data, sort_keys=True)))
            self._db.commit()

    def last_event_time(self, event: str) -> Optional[float]:
        """Rate-limiter query (log.rs:98-114)."""
        with self._lock:
            row = self._db.execute(
                "SELECT MAX(timestamp) FROM log WHERE event = ?",
                (event,)).fetchone()
        return row[0]

    def last_backup_size(self) -> Optional[int]:
        """Size-estimate source (log.rs:132-160)."""
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM log WHERE event = ? ORDER BY id DESC LIMIT 1",
                (EVENT_BACKUP,)).fetchone()
        if row is None:
            return None
        return json.loads(row[0]).get("size")
