"""Device manifest driver: streams -> resident batches -> (chunks, digests).

Port of the manifest path of ``backuwup_tpu/ops/pipeline.py``.
:meth:`DevicePipeline.manifest_batch` routes a batch of independent
streams:

* empty streams have no chunks;
* tiny streams (<= ``min_size``) are one chunk each and go straight to
  the batched digest (:func:`.blake3_gpu.blake3_many_gpu`, leaf kernel);
* long streams (> ``segment_size``) are chunked segment by segment
  (:class:`.cdc_gpu.GpuCdcScanner`) and digested by
  :meth:`DevicePipeline.digest_chunks`;
* the rest are bucketed by padded length into ``(B, 31+P)`` batches of at
  most 128 MiB and run through :meth:`manifest_segments_device`, the
  zero-round-trip driver: scan kernel -> on-device cut selection ->
  leaf-pool digest (leaf kernel), with one download per batch.

Host buffers are pinned; uploads and downloads are ``non_blocking`` on the
current stream, and a recorded CUDA event is synchronised before the host
reads a download.  Up to four batches are in flight.

Overflow follows the JAX driver: a row whose candidates overflowed is
re-chunked by the ``cdc_cpu`` oracle (and digested on the device); a
batch whose pool overflowed is re-digested by :meth:`digest_chunks`.
Each re-run is counted (``oracle_reruns``, ``pool_reruns``), and with
``strict_overflow`` either raises instead.

:meth:`DevicePipeline.manifest_batch_classified` adds the on-device dedup
handoff of the JAX mesh pipeline: each batch's digest accumulator goes to
the dedup table (``classify_dispatch``) on the same stream, and its
found/lost vectors ride the batch's download.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .blake3_gpu import blake3_many_gpu, digest_padded, digests_to_bytes
from .cdc_cpu import chunk_stream as chunk_stream_cpu
from .cdc_gpu import _HALO, GpuCdcScanner, _round_up, _segment_bucket
from .digest_pool import leaf_capacity
from .gear import CDCParams
from .manifest_device import scan_digest_batch_pool, tier_plan

CHUNK_LEN = 1024

# cap on one batch (rows x row bytes); keeps kernel offsets below 2^31
_SCAN_DISPATCH_BYTES = 128 * 1024 * 1024
# batches in flight in the zero-round-trip driver (device-memory high water)
_WINDOW = 4


def _decode_cut_row(row: np.ndarray):
    """One packed scan+select row -> (overflow, [(offset, length)...])."""
    overflow, n_cuts = int(row[0]), int(row[1])
    if overflow:
        return True, []
    ends = row[2:2 + n_cuts].astype(np.int64)
    offs = np.empty(n_cuts, dtype=np.int64)
    if n_cuts:
        offs[0] = 0
        np.add(ends[:-1], 1, out=offs[1:])
    lens = ends - offs + 1
    return False, list(zip(offs.tolist(), lens.tolist()))


def gather_chunks(stream: torch.Tensor, offsets: torch.Tensor, *,
                  l_bucket: int) -> torch.Tensor:
    """(B,) chunk offsets -> (B, l_bucket*1024) u8 spans of ``stream``,
    which must hold ``l_bucket*1024`` slack bytes past the last chunk."""
    span = l_bucket * CHUNK_LEN
    return stream.unfold(0, span, 1)[offsets.to(torch.int64)]


class DevicePipeline:
    """Chunk + fingerprint streams on one device."""

    def __init__(self, params: Optional[CDCParams] = None, device=None,
                 strict_overflow: bool = False):
        self.params = params or CDCParams()
        self.device = resolve_device(device)
        self.scanner = GpuCdcScanner(self.params, device=self.device)
        # leaves of the largest chunk: the top leaf bucket of digest_chunks
        self.l_bucket = max(16, -(-self.params.max_size // CHUNK_LEN))
        self.strict_overflow = strict_overflow
        self.oracle_reruns = 0  # rows re-chunked on the cdc_cpu oracle
        self.pool_reruns = 0    # batches re-digested after pool overflow

    def _caps(self, padded: int) -> Tuple[int, int, int]:
        """(s_cap, l_cap, cut_cap) for a padded row length: candidate
        capacity at 4x the expectation, as the JAX driver sizes it."""
        p = self.params
        l_cap = max(512, _round_up(4 * max(1, padded >> p.mask_l_bits), 512))
        cut_cap = padded // p.min_size + 1
        return l_cap, l_cap, cut_cap

    # --- host <-> device ---------------------------------------------------

    def _pinned(self) -> bool:
        return self.device.type == "cuda"

    def _host_bytes(self, data) -> torch.Tensor:
        """Host u8 tensor (pinned when the device is CUDA) holding ``data``."""
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        t = torch.empty(len(arr), dtype=torch.uint8, pin_memory=self._pinned())
        t.numpy()[:] = arr
        return t

    def _to_host(self, *tensors):
        """Start downloads; returns (host tensors, event or None).  The
        host must not read them before ``event.synchronize()``."""
        if self.device.type != "cuda":
            return list(tensors), None
        outs = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            outs.append(h)
        ev = torch.cuda.Event()
        ev.record()
        return outs, ev

    # --- digests of known chunks -------------------------------------------

    def _chunk_bucket(self, n_bytes: int) -> int:
        """Smallest leaf bucket (power of two, >= 16 leaves) holding a chunk."""
        need = max(1, -(-n_bytes // CHUNK_LEN))
        b = 16
        while b < need:
            b *= 2
        return min(b, self.l_bucket) if need <= self.l_bucket else need

    def digest_chunks(self, stream: torch.Tensor,
                      chunks: List[tuple]) -> np.ndarray:
        """Gather + digest chunk spans of a resident stream; (N, 32) u8.
        Chunks are grouped by leaf bucket into one (B, L) tile each, split
        only where a tile would exceed the dispatch budget."""
        if not chunks:
            return np.zeros((0, 32), dtype=np.uint8)
        stream = torch.cat([stream, stream.new_zeros(self.l_bucket * CHUNK_LEN)])
        groups: dict = {}
        for i, (_off, ln) in enumerate(chunks):
            groups.setdefault(self._chunk_bucket(ln), []).append(i)
        tiles = []
        for L, idxs in sorted(groups.items()):
            rows = max(1, _SCAN_DISPATCH_BYTES // (L * CHUNK_LEN))
            for s0 in range(0, len(idxs), rows):
                part = idxs[s0:s0 + rows]
                offs = np.array([chunks[i][0] for i in part], dtype=np.int64)
                lens = np.array([chunks[i][1] for i in part], dtype=np.int32)
                buf = gather_chunks(stream, torch.from_numpy(offs).to(
                    self.device), l_bucket=L)
                tiles.append((part, digest_padded(
                    buf, torch.from_numpy(lens).to(self.device), L=L)))
        out = np.zeros((len(chunks), 32), dtype=np.uint8)
        for part, root in tiles:
            out[part] = digests_to_bytes(root)
        return out

    def _oracle_row(self, row: bytes):
        """A row whose candidates overflowed: oracle chunks, device digests."""
        if self.strict_overflow:
            raise RuntimeError("candidate overflow in scan+select")
        self.oracle_reruns += 1
        chunks = chunk_stream_cpu(row, self.params)
        digs = blake3_many_gpu([row[o:o + ln] for o, ln in chunks],
                               device=self.device)
        return chunks, (np.frombuffer(b"".join(digs), dtype=np.uint8)
                        .reshape(-1, 32).copy())

    # --- the zero-round-trip driver ----------------------------------------

    def manifest_segments_device(self, segments, dedup=None):
        """Pipelined driver over batches (generator).

        ``segments`` yields host ``(buf, nv)``: ``buf`` a (B, 31+P) u8
        tensor (pinned for CUDA; rows are 31 zero bytes, then the stream,
        zero padded), ``nv`` a (B,) int32 numpy array of true lengths.
        Yields, per batch, a list of per-row ``(chunks, digests)``.

        With ``dedup`` (a ``MeshDedupIndex``) each batch's digest
        accumulator is handed to the dedup table on the device
        (``classify_dispatch``, no host round trip) and the generator
        yields ``(rows, flags)``: ``flags[r]`` is the row's per-chunk
        found-vector (truthy = resident before the batch's insert) or
        ``None`` when the device could not classify the row (candidate or
        pool overflow, a lost lane); ``resolve_hints`` finishes the job.
        The whole slab is inserted unmasked, as in the JAX pipeline:
        unplaced lanes are all-zero padding, and a re-run row's true
        digests are re-inserted from the host by ``resolve_hints``.
        """
        p = self.params
        it = iter(segments)
        pending: deque = deque()

        def dispatch() -> bool:
            for buf_h, nv in it:
                buf_d = buf_h.to(self.device, non_blocking=True)
                nv_d = torch.from_numpy(np.asarray(nv, dtype=np.int32)).to(
                    self.device)
                B = int(buf_d.shape[0])
                padded = int(buf_d.shape[1]) - _HALO
                s_cap, l_cap, cut_cap = self._caps(padded)
                rets = scan_digest_batch_pool(
                    buf_d, nv_d, min_size=p.min_size,
                    desired_size=p.desired_size, max_size=p.max_size,
                    mask_s=p.mask_s, mask_l=p.mask_l, s_cap=s_cap,
                    l_cap=l_cap, cut_cap=cut_cap,
                    leaf_cap=leaf_capacity(B * padded, B * cut_cap),
                    tiers=tier_plan(p, B * padded, B),
                    emit_queries=dedup is not None)
                if dedup is not None:
                    # same stream, no sync: the table reads acc in order
                    found_d, lost_d = dedup.classify_dispatch(rets[3])
                    rets = rets[:3] + (found_d, lost_d)
                host, ev = self._to_host(*rets)
                pending.append((buf_h, buf_d, nv, cut_cap, host, ev))
                return True
            return False

        for _ in range(_WINDOW):
            dispatch()
        while pending:
            buf_h, buf_d, nv, cut_cap, host, ev = pending.popleft()
            dispatch()
            if ev is not None:
                ev.synchronize()
            packed, acc, ovf = (t.numpy() for t in host[:3])
            B = packed.shape[0]
            nv = np.asarray(nv, dtype=np.int64)
            pool_ok = not ovf.any()
            if not pool_ok:
                if self.strict_overflow:
                    raise RuntimeError("leaf-pool overflow in device manifest")
                self.pool_reruns += 1
            dig8 = np.ascontiguousarray(acc).view(np.uint8).reshape(
                -1, cut_cap, 32)
            found = lost = None
            if dedup is not None:
                found, lost = (t.numpy().reshape(B, cut_cap) for t in host[3:])
                note = getattr(dedup, "note_window", None)
                if note is not None:
                    n_real = int(packed[packed[:, 0] == 0, 1].sum())
                    note(n_real, int((lost != 0).sum()))
            out = []
            flags: List = [None] * B
            for r in range(B):
                overflow, chunks = _decode_cut_row(packed[r])
                if overflow:
                    row = buf_h[r, _HALO:_HALO + nv[r]].numpy().tobytes()
                    out.append(self._oracle_row(row))
                elif pool_ok:
                    out.append((chunks, dig8[r, :len(chunks)].copy()))
                    n = len(chunks)
                    if found is not None and not lost[r, :n].any():
                        flags[r] = found[r, :n] != 0
                else:
                    out.append((chunks, self.digest_chunks(
                        buf_d[r, _HALO:_HALO + nv[r]], chunks)))
            yield out if dedup is None else (out, flags)

    # --- stream routing ----------------------------------------------------

    def _manifest_prepass(self, streams, out: List) -> dict:
        """Fill ``out`` for empty, tiny and long streams; return the
        {padded_len: [idx...]} groups the batched driver consumes."""
        p = self.params
        tiny: List[int] = []
        groups: dict = {}
        for i, s in enumerate(streams):
            n = len(s)
            if n == 0:
                out[i] = ([], np.zeros((0, 32), dtype=np.uint8))
            elif n <= p.min_size:
                # a sub-min stream is exactly one chunk: no scan needed
                tiny.append(i)
            elif n > self.scanner.segment_size:
                chunks = self.scanner.chunk_stream(s)
                dev = self._host_bytes(s).to(self.device, non_blocking=True)
                out[i] = (chunks, self.digest_chunks(dev, chunks))
            else:
                groups.setdefault(_segment_bucket(n), []).append(i)
        if tiny:
            digs = blake3_many_gpu([streams[i] for i in tiny],
                                   device=self.device)
            for i, d in zip(tiny, digs):
                out[i] = ([(0, len(streams[i]))],
                          np.frombuffer(d, dtype=np.uint8).reshape(1, 32))
        return groups

    def _bucketed_batches(self, streams, groups: dict, batch_rows: deque):
        """Generator of host (buf, nv) batches for the grouped streams;
        appends each batch's stream indices to ``batch_rows``."""
        for padded, idxs in sorted(groups.items()):
            row = _HALO + padded
            max_rows = max(1, _SCAN_DISPATCH_BYTES // row)
            for s0 in range(0, len(idxs), max_rows):
                part = idxs[s0:s0 + max_rows]
                buf = torch.zeros((len(part), row), dtype=torch.uint8,
                                  pin_memory=self._pinned())
                view = buf.numpy()
                nv = np.zeros(len(part), dtype=np.int32)
                for r, i in enumerate(part):
                    d = np.frombuffer(bytes(streams[i]), dtype=np.uint8)
                    view[r, _HALO:_HALO + len(d)] = d
                    nv[r] = len(d)
                batch_rows.append(part)
                yield buf, nv

    def manifest_batch(self, streams) -> List[Tuple[List[tuple], np.ndarray]]:
        """Chunk + fingerprint a batch of independent streams; one
        ``(chunks, digests)`` pair per stream, bit-identical to the oracle
        pipeline (``cdc_cpu.chunk_stream`` + ``blake3_cpu``)."""
        return self.manifest_batch_classified(streams, None)[0]

    def manifest_batch_classified(self, streams, dedup):
        """:meth:`manifest_batch` with the on-device dedup handoff: returns
        ``(out, flags)`` where ``flags[i]`` is stream i's per-chunk device
        found-vector or ``None`` when the device could not classify it
        (empty, tiny and long streams, overflow re-runs, lost lanes; the
        host authority resolves those in ``resolve_hints``).  Without
        ``dedup`` every flag is ``None``."""
        out: List[Optional[Tuple[List[tuple], np.ndarray]]] = [None] * len(streams)
        flags: List[Optional[np.ndarray]] = [None] * len(streams)
        groups = self._manifest_prepass(streams, out)
        batch_rows: deque = deque()
        gen = self._bucketed_batches(streams, groups, batch_rows)
        for item in self.manifest_segments_device(gen, dedup=dedup):
            rows, rowflags = (item, None) if dedup is None else item
            for r, i in enumerate(batch_rows.popleft()):
                out[i] = rows[r]
                if rowflags is not None:
                    flags[i] = rowflags[r]
        return out, flags
