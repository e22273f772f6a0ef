"""Deterministic, seedable fault-injection plane for the p2p data plane.

Counterpart of ``backuwup_tpu/utils/faults.py``, with its own registry
of crash sites (the same site names, registered when the port's modules
import).  The port has no network plane yet, so only the crash points
and the plane itself are reached from its code.

The chaos harness of the framework: tests (or an operator via the
``BKW_FAULTS`` env var) install a :class:`FaultPlane` and the hooks at the
Transport/Node seam of the reference's ``net/p2p.py`` start injecting

* **drop_send** — the connection dies mid-``send_data`` (socket closed,
  sender sees a ``P2PError``),
* **corrupt_frame** — one byte of the signed frame is flipped in flight
  (the receiver's signature check drops it; the sender times out on the
  ack),
* **withhold_ack** — the receiver persists the file but the ack never
  leaves (the crash-between-write-and-ack window; exercises the
  idempotent re-send path),
* **latency** — an extra await before the frame goes out,
* **peer death** — a peer id is marked dead: it answers no rendezvous,
  accepts no dial, and every in-flight transport to it fails on the next
  send.  :meth:`FaultPlane.kill_after` arms death after N successful
  sends — "the peer vanished mid-backup".
* **mid-transfer cuts** — :meth:`FaultPlane.arm_cut` arms exact byte
  offsets per peer; the chunked sender dies on the FILE_PART covering an
  armed offset (``cut_part`` is the rate-based version).  The resume
  protocol (docs/transfer.md) must continue from the persisted offset.
* **flaky reconnect** — ``reconnect_fail`` makes a fraction of p2p dials
  fail outright, the residential-NAT reconnect lottery.
* **crash points** — named :func:`crashpoint` sites at every multi-step
  commit seam (pack-seal, blob-index save, challenge-table save,
  placement insert, stripe finish, repair re-home, partial sink).  When
  armed (``arm_crash`` exact, or the seeded ``crash`` rate) the site
  raises :class:`CrashInjected` — deliberately a ``BaseException`` so no
  blanket ``except Exception`` recovery path can absorb the "process
  died here" signal — or, with ``crash_hard`` set (subprocess mode),
  hard-exits via ``os._exit`` with :data:`CRASH_EXIT_CODE`, the closest
  in-tree approximation of ``kill -9`` at that instruction.  Sites
  self-register through :func:`register_crash_site` at import, so the
  crash-matrix harness can enumerate :func:`crash_sites` without a
  hand-kept list.

Two properties the acceptance bar demands, by construction:

* **Inert when disabled.**  The module-global :data:`PLANE` is ``None``
  unless explicitly installed; every hook site is a single
  ``faults.PLANE is not None`` check, so the production path pays one
  attribute load and no frames, allocations, or RNG draws.
* **Deterministic under a seed.**  Every decision site draws from its own
  ``random.Random`` seeded by ``(plane seed, site name)``, so the answer
  stream of one site is a pure function of the seed and that site's query
  count — independent of how asyncio interleaves *other* sites.  Tests
  that need exact placement use :meth:`arm` (fire on the Nth query) which
  bypasses probability entirely.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import random
from typing import Dict, Optional, Set

from ..obs import journal as obs_journal
from ..obs import metrics as obs_metrics

#: send_data asks this before shipping a FILE frame
ACT_DROP = "drop"
ACT_CORRUPT = "corrupt"

#: Process exit status used by hard crash injection (``crash_hard``) so a
#: supervising test can tell an injected crash from a real fault.
CRASH_EXIT_CODE = 70


class CrashInjected(BaseException):
    """The process "died" at a named crash point.

    Derives from ``BaseException`` on purpose: the commit seams sit under
    broad ``except Exception`` guards (challenge-table save, send jobs)
    that must NOT be able to swallow an injected crash — a real power cut
    would not have run those handlers either.
    """

    def __init__(self, site: str):
        super().__init__(site)
        self.site = site


#: Every crash-point name ever registered in this process, in module
#: import order of the seams.  The crash-matrix harness enumerates this.
CRASH_SITES: Set[str] = set()


def register_crash_site(site: str) -> str:
    """Declare a crash point at module import; returns ``site`` so call
    sites can bind it to a constant: ``_CP = faults.register_crash_site(
    "pack.seal.pre")``."""
    CRASH_SITES.add(site)
    return site


def crash_sites() -> tuple:
    """Sorted tuple of every registered crash point (matrix input)."""
    return tuple(sorted(CRASH_SITES))

_INJECTIONS = obs_metrics.counter(
    "bkw_fault_injections_total", "Fault-plane firings by hook site",
    ("site",))


def _record_injection(site: str) -> None:
    # metric label is the hook prefix (site minus the ':<peer hex>' tail)
    # so cardinality stays bounded; the journal keeps the full site
    _INJECTIONS.inc(site=site.split(":", 1)[0])
    obs_journal.emit("fault", site=site)


def _site_seed(seed: int, site: str) -> int:
    digest = hashlib.blake2s(f"{seed}:{site}".encode()).digest()[:8]
    return int.from_bytes(digest, "little")


class FaultPlane:
    """One installed chaos configuration.

    ``rates`` are per-query probabilities in [0, 1]; ``arm`` pins exact
    query indices per site for deterministic tests.  Site names follow
    ``<hook>:<peer hex>`` so each peer direction has an independent
    stream.
    """

    def __init__(self, seed: int = 0, *, drop_send: float = 0.0,
                 corrupt_frame: float = 0.0, withhold_ack: float = 0.0,
                 latency: float = 0.0, latency_s: float = 0.05,
                 cut_part: float = 0.0, reconnect_fail: float = 0.0,
                 crash: float = 0.0, crash_hard: bool = False):
        self.seed = int(seed)
        self.drop_send = float(drop_send)
        self.corrupt_frame = float(corrupt_frame)
        self.withhold_ack = float(withhold_ack)
        self.latency = float(latency)
        self.latency_s = float(latency_s)
        self.cut_part = float(cut_part)
        self.reconnect_fail = float(reconnect_fail)
        self.crash = float(crash)
        self.crash_hard = bool(crash_hard)
        self.dead: Set[bytes] = set()
        self._cuts: Dict[bytes, Set[int]] = {}
        self._kill_after: Dict[bytes, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._queries: Dict[str, int] = {}
        self._armed: Dict[str, Set[int]] = {}
        #: observability: fires per site, for test assertions and logs
        self.fired: Dict[str, int] = {}

    # --- deterministic decision core ---------------------------------------

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(
                _site_seed(self.seed, site))
        return rng

    def arm(self, site: str, *query_indices: int) -> None:
        """Force ``site`` to fire on exactly these (0-based) query indices,
        regardless of rates — the deterministic-placement test API."""
        self._armed.setdefault(site, set()).update(query_indices)

    def decide(self, site: str, rate: float) -> bool:
        """One decision draw at ``site``; counts queries and fires."""
        q = self._queries.get(site, 0)
        self._queries[site] = q + 1
        hit = q in self._armed.get(site, ())
        if not hit and rate > 0.0:
            hit = self._rng(site).random() < rate
        elif rate > 0.0:
            # keep the stream position consistent whether or not armed
            # indices interleave, so arming never shifts later draws
            self._rng(site).random()
        if hit:
            self.fired[site] = self.fired.get(site, 0) + 1
            _record_injection(site)
        return hit

    # --- crash points -------------------------------------------------------

    def arm_crash(self, site: str, *query_indices: int) -> None:
        """Arm crash point ``site`` (a :data:`CRASH_SITES` name) to fire
        on the given 0-based query indices — the first query when none
        are given.  The deterministic crash-matrix API."""
        self.arm(f"crash.{site}", *(query_indices or (0,)))

    def crashpoint(self, site: str) -> None:
        """One pass through crash point ``site``.  Free unless the crash
        kind is active (armed or rated); fires at most what
        :meth:`decide` says; raises :class:`CrashInjected`, or hard-exits
        the process when ``crash_hard`` is set."""
        key = f"crash.{site}"
        if self.crash <= 0.0 and key not in self._armed:
            return
        if not self.decide(key, self.crash):
            return
        if self.crash_hard:
            try:
                obs_journal.emit("crash_injected", site=site, hard=True)
            except Exception:
                pass
            os._exit(CRASH_EXIT_CODE)
        raise CrashInjected(site)

    # --- peer death ---------------------------------------------------------

    def kill(self, peer_id: bytes) -> None:
        self.dead.add(bytes(peer_id))

    def revive(self, peer_id: bytes) -> None:
        self.dead.discard(bytes(peer_id))
        self._kill_after.pop(bytes(peer_id), None)

    def kill_after(self, peer_id: bytes, sends: int) -> None:
        """Peer drops dead after ``sends`` more successful FILE sends."""
        self._kill_after[bytes(peer_id)] = int(sends)

    def is_dead(self, peer_id: bytes) -> bool:
        return bytes(peer_id) in self.dead

    def _count_send(self, peer_id: bytes) -> bool:
        """Advance the kill_after counter; True when this send is the one
        that finds the peer dead."""
        k = bytes(peer_id)
        if k not in self._kill_after:
            return False
        if self._kill_after[k] <= 0:
            del self._kill_after[k]
            self.dead.add(k)
            return True
        self._kill_after[k] -= 1
        return False

    # --- hooks consumed by net/p2p.py ---------------------------------------

    async def on_send(self, peer_id: bytes) -> Optional[str]:
        """Called by Transport.send_data before shipping a FILE frame.
        Returns ACT_DROP / ACT_CORRUPT / None; sleeps injected latency."""
        hexid = bytes(peer_id).hex()
        if self.latency > 0.0 and self.decide(f"send.latency:{hexid}",
                                              self.latency):
            await asyncio.sleep(self.latency_s)
        if self._count_send(peer_id) or self.is_dead(peer_id):
            self.fired[f"send.dead:{hexid}"] = \
                self.fired.get(f"send.dead:{hexid}", 0) + 1
            _record_injection(f"send.dead:{hexid}")
            return ACT_DROP
        if self.decide(f"send.drop:{hexid}", self.drop_send):
            return ACT_DROP
        if self.decide(f"send.corrupt:{hexid}", self.corrupt_frame):
            return ACT_CORRUPT
        return None

    def arm_cut(self, peer_id: bytes, *offsets: int) -> None:
        """Arm exact-offset mid-transfer cuts toward ``peer_id``: the
        connection dies on the FILE_PART whose byte range covers an armed
        offset (one-shot per offset) — "the WAN link dropped at byte N of
        the shard", the deterministic-resume test API."""
        self._cuts.setdefault(bytes(peer_id), set()).update(
            int(o) for o in offsets)

    def on_send_part(self, peer_id: bytes, offset: int,
                     size: int) -> Optional[str]:
        """Called before shipping a FILE_PART covering
        ``[offset, offset + size)``.  Exact-offset cuts fire first (armed,
        one-shot), then the seeded ``cut_part`` rate."""
        hexid = bytes(peer_id).hex()
        armed = self._cuts.get(bytes(peer_id))
        if armed:
            hit = [c for c in armed if offset <= c < offset + size]
            if hit:
                for c in hit:
                    armed.discard(c)
                site = f"send.cut:{hexid}"
                self.fired[site] = self.fired.get(site, 0) + 1
                _record_injection(site)
                return ACT_DROP
        if self.cut_part > 0.0 and self.decide(f"send.cut:{hexid}",
                                               self.cut_part):
            return ACT_DROP
        return None

    def flaky_reconnect(self, peer_id: bytes) -> bool:
        """Called by P2PNode.connect before dialing: True = this dial is
        refused, as a flaky residential peer would."""
        return self.decide(f"dial.flaky:{bytes(peer_id).hex()}",
                           self.reconnect_fail)

    def corrupt(self, raw: bytes, peer_id: bytes) -> bytes:
        """Flip one deterministically chosen byte of the signed frame."""
        rng = self._rng(f"corrupt.byte:{bytes(peer_id).hex()}")
        i = rng.randrange(len(raw))
        return raw[:i] + bytes([raw[i] ^ 0xFF]) + raw[i + 1:]

    def withhold_ack_now(self, peer_id: bytes) -> bool:
        """Called by Receiver.run after the sink persisted the file."""
        return self.decide(f"recv.withhold_ack:{bytes(peer_id).hex()}",
                           self.withhold_ack)


#: The installed plane; None (the default) disables every hook.
PLANE: Optional[FaultPlane] = None


def install(plane: FaultPlane) -> FaultPlane:
    global PLANE
    PLANE = plane
    return plane


def uninstall() -> None:
    global PLANE
    PLANE = None


def crashpoint(site: str) -> None:
    """The module-level crash hook the commit seams call.  One attribute
    load when no plane is installed — same inertness contract as every
    other hook site."""
    plane = PLANE
    if plane is not None:
        plane.crashpoint(site)


def from_env(spec: Optional[str] = None) -> Optional[FaultPlane]:
    """Parse a ``BKW_FAULTS`` spec into a plane (None when unset/empty).

    Format: comma-separated ``key=value``; keys ``seed``, ``drop_send``,
    ``corrupt_frame``, ``withhold_ack``, ``latency`` (probability),
    ``latency_s`` (seconds), ``kill`` ('+'-separated hex client ids),
    ``crash`` ('+'-separated crash sites, each optionally ``site@N`` to
    fire on the Nth query instead of the first), ``crash_rate``
    (probability across every crash point) and ``crash_hard`` (0/1:
    convert an injected crash into a hard ``os._exit`` — the subprocess
    kill -9 mode).
    Example: ``BKW_FAULTS=seed=7,drop_send=0.05,latency=0.2,latency_s=0.1``
    or ``BKW_FAULTS=crash=placement.insert.post@1,crash_hard=1``
    """
    spec = os.environ.get("BKW_FAULTS", "") if spec is None else spec
    spec = spec.strip()
    if not spec:
        return None
    kw: Dict[str, float] = {}
    kills = []
    crashes = []
    crash_hard = False
    for part in spec.split(","):
        if not part.strip():
            continue
        key, _, value = part.partition("=")
        key = key.strip()
        value = value.strip()
        if key == "kill":
            kills.extend(bytes.fromhex(v) for v in value.split("+") if v)
        elif key == "seed":
            kw["seed"] = int(value)
        elif key == "crash":
            for v in value.split("+"):
                if not v:
                    continue
                site, _, at = v.partition("@")
                crashes.append((site, int(at) if at else 0))
        elif key == "crash_rate":
            kw["crash"] = float(value)
        elif key == "crash_hard":
            crash_hard = value.lower() not in ("", "0", "false", "no")
        elif key in ("drop_send", "corrupt_frame", "withhold_ack",
                     "latency", "latency_s", "cut_part", "reconnect_fail"):
            kw[key] = float(value)
        else:
            raise ValueError(f"unknown BKW_FAULTS key {key!r}")
    seed = int(kw.pop("seed", 0))
    plane = FaultPlane(seed, crash_hard=crash_hard, **kw)
    for k in kills:
        plane.kill(k)
    for site, at in crashes:
        plane.arm_crash(site, at)
    return plane


# env activation at import time: the p2p module imports this module, so a
# process started with BKW_FAULTS set gets the plane with no test plumbing
if os.environ.get("BKW_FAULTS"):
    PLANE = from_env()
