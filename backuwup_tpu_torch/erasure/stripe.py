"""Shard containers and stripe assembly.

Counterpart of ``backuwup_tpu/erasure/stripe.py``, copied over the port's
backend (``encode_shards``/``decode_shards``/``digest_many``) and
``snapshot.packfile``; its containers are byte-identical.

A sealed packfile is split into ``k`` data + ``m`` parity shards; each
shard ships as a small self-describing container so the restore/repair
side needs no out-of-band metadata:

    magic ``BKWS`` (4) | version u8 | shard index u8 | k u8 | m u8 |
    orig_len u64 LE | BLAKE3(payload) (32) | payload

The per-shard digest is what makes corrupted-shard *detection* (vs mere
reconstruction failure) possible: a container whose payload hash
mismatches is dropped before it can poison the GF solve, and any k
clean survivors still reconstruct.

Shard ids on the wire and in the audit plane are the 12-byte packfile id
plus one index byte (13 bytes, :func:`shard_id`).  Encode is
deterministic — re-splitting a packfile or rebuilding a lost shard from
survivors reproduces byte-identical containers — which keeps re-sends
idempotent and pre-computed per-shard audit challenge tables valid after
repair.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import gf_cpu

MAGIC = b"BKWS"
VERSION = 1
HEADER_LEN = 4 + 1 + 1 + 1 + 1 + 8 + 32  # 48
DIGEST_LEN = 32
SHARD_ID_LEN = 13  # 12-byte packfile id + 1 index byte


class StripeError(Exception):
    pass


def shard_id(packfile_id: bytes, index: int) -> bytes:
    return bytes(packfile_id) + bytes([index])


def parse_shard_id(sid: bytes) -> Tuple[bytes, int]:
    sid = bytes(sid)
    if len(sid) != SHARD_ID_LEN:
        raise StripeError(f"bad shard id length {len(sid)}")
    return sid[:-1], sid[-1]


@dataclass(frozen=True)
class Shard:
    """One parsed container (digest NOT yet verified — see
    :func:`collect_shards`)."""

    index: int
    k: int
    m: int
    orig_len: int
    digest: bytes
    payload: bytes


def pack_shard(index: int, k: int, m: int, orig_len: int, digest: bytes,
               payload: bytes) -> bytes:
    if len(digest) != DIGEST_LEN:
        raise StripeError("bad shard digest length")
    return (MAGIC + bytes([VERSION, index, k, m])
            + struct.pack("<Q", orig_len) + digest + payload)


def parse_shard(blob: bytes) -> Shard:
    blob = bytes(blob)
    if len(blob) < HEADER_LEN or blob[:4] != MAGIC:
        raise StripeError("not a shard container")
    if blob[4] != VERSION:
        raise StripeError(f"unsupported shard version {blob[4]}")
    index, k, m = blob[5], blob[6], blob[7]
    (orig_len,) = struct.unpack("<Q", blob[8:16])
    digest, payload = blob[16:48], blob[48:]
    if not (1 <= k and k + m <= 256 and index < k + m):
        raise StripeError(f"bad shard geometry idx={index} k={k} m={m}")
    if len(payload) != gf_cpu.shard_len(orig_len, k):
        raise StripeError("shard payload length mismatch")
    return Shard(index=index, k=k, m=m, orig_len=orig_len, digest=digest,
                 payload=payload)


def split_packfile(data: bytes, k: int, m: int, backend) -> List[bytes]:
    """Encode ``data`` into k + m shard containers (deterministic)."""
    data = bytes(data)
    data_shards = gf_cpu.split_data(data, k)
    parity = backend.encode_shards(data_shards[None], m)[0]
    rows = np.concatenate([data_shards, parity], axis=0)
    payloads = [rows[i].tobytes() for i in range(k + m)]
    digests = backend.digest_many(payloads)
    return [pack_shard(i, k, m, len(data), digests[i], payloads[i])
            for i in range(k + m)]


def collect_shards(containers: Iterable[bytes], backend,
                   ) -> Tuple[Dict[int, Shard], Optional[Tuple[int, int, int]],
                              List[str]]:
    """Parse + digest-verify containers; drop (and report) bad ones.

    Returns ``(shards_by_index, (k, m, orig_len) or None, drop_reasons)``.
    """
    parsed: List[Shard] = []
    drops: List[str] = []
    for blob in containers:
        try:
            parsed.append(parse_shard(blob))
        except StripeError as e:
            drops.append(str(e))
    good = parsed and backend.digest_many([s.payload for s in parsed])
    shards: Dict[int, Shard] = {}
    geom: Optional[Tuple[int, int, int]] = None
    for s, digest in zip(parsed, good or []):
        if digest != s.digest:
            drops.append(f"shard {s.index}: payload digest mismatch")
            continue
        if geom is None:
            geom = (s.k, s.m, s.orig_len)
        elif (s.k, s.m, s.orig_len) != geom:
            drops.append(f"shard {s.index}: inconsistent stripe geometry")
            continue
        shards[s.index] = s
    return shards, geom, drops


def _decode_data(shards: Dict[int, Shard], k: int, m: int,
                 backend) -> np.ndarray:
    present = sorted(shards)[:k]
    stacked = np.stack([np.frombuffer(shards[i].payload, dtype=np.uint8)
                        for i in present], axis=0)
    return backend.decode_shards(stacked[None], k, m, present)[0]


def assemble_packfile(containers: Iterable[bytes], backend) -> bytes:
    """Reconstruct the original packfile bytes from any k valid shards."""
    shards, geom, drops = collect_shards(containers, backend)
    if geom is None:
        raise StripeError("no valid shard containers: " + "; ".join(drops))
    k, m, orig_len = geom
    if len(shards) < k:
        raise StripeError(
            f"only {len(shards)} valid shards, need {k}"
            + (": " + "; ".join(drops) if drops else ""))
    return gf_cpu.join_data(_decode_data(shards, k, m, backend), orig_len)


def rebuild_shards(containers: Iterable[bytes], missing: Sequence[int],
                   backend) -> Dict[int, bytes]:
    """Rebuild the ``missing`` shard containers from any k survivors.

    Byte-identical to the originals (sourceless repair leans on this)."""
    shards, geom, drops = collect_shards(containers, backend)
    if geom is None:
        raise StripeError("no valid shard containers: " + "; ".join(drops))
    k, m, orig_len = geom
    if len(shards) < k:
        raise StripeError(f"only {len(shards)} valid shards, need {k}")
    data = _decode_data(shards, k, m, backend)
    parity = None
    if any(int(i) >= k for i in missing):
        parity = backend.encode_shards(data[None], m)[0]
    out: Dict[int, bytes] = {}
    for idx in missing:
        idx = int(idx)
        if not 0 <= idx < k + m:
            raise StripeError(f"shard index {idx} out of range")
        row = data[idx] if idx < k else parity[idx - k]
        payload = np.asarray(row, dtype=np.uint8).tobytes()
        digest = backend.digest_many([payload])[0]
        out[idx] = pack_shard(idx, k, m, orig_len, digest, payload)
    return out


def iter_shard_dirs(shard_root: Path):
    """Yield ``(packfile_id, [container bytes...])`` under a shard tree.

    Layout (written by ``RestoreFilesWriter``): ``shard_root/<pid hex>/
    <index>``.  Unparseable directory names are skipped.
    """
    if not shard_root.is_dir():
        return
    for pid_dir in sorted(shard_root.iterdir()):
        try:
            pid = bytes.fromhex(pid_dir.name)
        except ValueError:
            continue
        if not pid_dir.is_dir() or len(pid) != 12:
            continue
        blobs = [p.read_bytes() for p in sorted(pid_dir.iterdir())
                 if p.is_file()]
        yield pid, blobs


def assemble_tree(shard_root: Path, pack_root: Path, backend,
                  ) -> Tuple[List[bytes], List[Tuple[bytes, str]]]:
    """Reconstruct every stripe under ``shard_root`` into ``pack_root``.

    The restore path calls this after the pull phase: reconstructed
    packfiles land exactly where whole-packfile streams would have, so
    everything downstream (coverage check, unpack) is stripe-blind.
    Returns ``(assembled_pids, [(pid, reason) failures])``.
    """
    from ..snapshot.packfile import packfile_path

    done: List[bytes] = []
    failed: List[Tuple[bytes, str]] = []
    for pid, blobs in iter_shard_dirs(shard_root):
        out = packfile_path(pack_root, pid)
        if out.exists():
            done.append(pid)
            continue
        try:
            data = assemble_packfile(blobs, backend)
        except StripeError as e:
            failed.append((pid, str(e)))
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(data)
        done.append(pid)
    return done, failed
