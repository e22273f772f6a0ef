"""Consistent-hash ring router for the federated coordination plane.

Counterpart of ``backuwup_tpu/net/ring.py``, copied so that the port
imports nothing of the JAX package.

No reference equivalent — the reference server is one process over one
Postgres.  Here the coordination plane goes horizontal: N nodes each run
the stateless request tier (net/server.py) over a shared pubkey-keyed
store, and this module decides *which* node owns a pubkey.

Design (docs/server.md §Federation):

* Each node contributes ``vnodes`` points on a 64-bit ring, at
  ``blake2b(f"{node_id}:{i}")`` — deterministic, so every node (and
  every client shipped the node list) computes the identical ring with
  no coordination traffic.
* ``owner(key)`` hashes the key onto the ring and walks clockwise to
  the first point (bisect over the sorted point list, O(log n·v)).
* Bounded movement: removing a node deletes only its own points, so
  exactly the keys it owned move (to their ring successors); adding a
  node claims ~1/N of the keyspace and moves nothing else.  The ring
  ownership-stability tests in tests/test_federation.py pin both.
* ``steal_order(node)`` federates the in-process steal semantics of
  ``ShardedMatchmaker._pop_candidate`` (home shard LAST): by the time a
  node goes remote it has already walked all of its local shards, so
  the remote order is simply the other nodes in ring-successor order
  starting after ``node`` — deterministic, and adjacent nodes (which
  absorb each other's keys on failure) are tried first.

``partition_of`` maps pubkeys to store partitions with the same prefix
convention as ``ShardedMatchmaker.shard_of`` — partition count is a file
-layout constant, NOT the ring (nodes come and go; partitions don't).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence

from .. import defaults

__all__ = ["HashRing", "partition_of", "partition_key", "successors"]


def _point(label: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(label.encode(), digest_size=8).digest(), "big")


def _key_point(key: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(bytes(key), digest_size=8).digest(), "big")


def partition_of(pubkey: bytes, partitions: int) -> int:
    """Store partition index for ``pubkey`` (same convention as
    ``ShardedMatchmaker.shard_of``: big-endian 8-byte prefix, modulo)."""
    prefix = bytes(pubkey)[:8] or b"\x00"
    return int.from_bytes(prefix, "big") % max(1, int(partitions))


def partition_key(partition: int) -> bytes:
    """Deterministic ring key for a store partition *index*.

    Replication homes whole partitions (a file-layout unit), not
    individual pubkeys, so each partition needs one stable ring position
    every node computes identically.  Hashing the label keeps partition
    placement independent of the pubkey distribution."""
    return hashlib.blake2b(b"bkw-partition:%d" % int(partition),
                           digest_size=16).digest()


def successors(ring: "HashRing", partition: int,
               count: Optional[int] = None) -> List[str]:
    """The replication chain for ``partition``: ring-successor nodes
    after its owner, most-senior first, capped at ``count``
    (``defaults.REPL_SUCCESSORS``).  Empty when the ring has one node
    (standalone mode: no one to ship to)."""
    owner = ring.owner(partition_key(partition))
    if owner is None:
        return []
    limit = defaults.REPL_SUCCESSORS if count is None else int(count)
    return ring.steal_order(owner)[:max(0, limit)]


class HashRing:
    """Deterministic consistent-hash ring: pubkey -> owning node id."""

    def __init__(self, nodes: Sequence[str] = (),
                 vnodes: Optional[int] = None):
        self.vnodes = int(vnodes or defaults.FEDERATION_RING_VNODES)
        self._points: List[int] = []        # sorted ring positions
        self._owners: Dict[int, str] = {}   # position -> node id
        for node in nodes:
            self.add(node)

    def add(self, node_id: str) -> None:
        if node_id in self.nodes():
            return
        for i in range(self.vnodes):
            pt = _point(f"{node_id}:{i}")
            # blake2b collisions across distinct labels are not a
            # realistic event; first writer keeps the point.
            if pt in self._owners:
                continue
            self._owners[pt] = node_id
            bisect.insort(self._points, pt)

    def remove(self, node_id: str) -> None:
        mine = [pt for pt, n in self._owners.items() if n == node_id]
        for pt in mine:
            del self._owners[pt]
            idx = bisect.bisect_left(self._points, pt)
            del self._points[idx]

    def nodes(self) -> List[str]:
        """All node ids, in ring order of their first point."""
        seen: List[str] = []
        for pt in self._points:
            n = self._owners[pt]
            if n not in seen:
                seen.append(n)
        return seen

    def __len__(self) -> int:
        return len(self.nodes())

    def owner(self, key: bytes) -> Optional[str]:
        if not self._points:
            return None
        idx = bisect.bisect_right(self._points, _key_point(key))
        if idx == len(self._points):
            idx = 0
        return self._owners[self._points[idx]]

    def steal_order(self, node_id: str) -> List[str]:
        """Other nodes in ring-successor order starting after
        ``node_id`` — the federated continuation of the in-process
        home-shard-last walk (``node_id`` itself is excluded: its local
        shards were already drained before going remote)."""
        order = self.nodes()
        if node_id not in order:
            return order
        at = order.index(node_id)
        return order[at + 1:] + order[:at]
