"""ChunkerBackend: one manifest contract, oracle and GPU executions.

Port of the manifest half of ``backuwup_tpu/ops/backend.py``.  A backend
turns raw bytes into chunk manifests (cut points + BLAKE3 fingerprints):

* :class:`CpuBackend` -- the numpy oracle pipeline;
* :class:`GpuBackend` -- the device pipeline (:class:`.pipeline.DevicePipeline`):
  CUDA scan kernel, on-device cut selection, leaf-pool BLAKE3 with the
  CUDA leaf kernel;
* :func:`select_backend` -- ``"gpu"`` or ``None`` picks the GPU and raises
  without CUDA; ``"cpu"`` picks the oracle.  Both give bit-identical
  manifests.

``manifest_many_classified`` adds the dedup hints: two passes (manifest,
then ``dedup.classify_insert``) on the base class, and on
:class:`GpuBackend` one pass that hands each batch's digests to the
device dedup table mid-manifest.

The host path of the base class records the reference's dispatch
accounting (``obs/profile.py``: scan, select, gather, digest, index);
the device pipeline of :class:`GpuBackend` records none yet.

``encode_shards`` / ``decode_shards`` are the Reed-Solomon product of the
erasure stripes (``erasure/``): the numpy oracle on the base class (so
:class:`CpuBackend` has them), the device product
(:mod:`..erasure.rs_gpu`, kernel K6) on :class:`GpuBackend`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..erasure import gf_cpu, rs_gpu
from ..obs import profile as obs_profile
from .blake3_cpu import blake3_many
from .blake3_gpu import blake3_many_gpu
from .cdc_cpu import chunk_stream as chunk_stream_cpu
from .gear import CDCParams
from .pipeline import DevicePipeline


@dataclass(frozen=True)
class ChunkRef:
    """One chunk of one stream: location + fingerprint."""

    offset: int
    length: int
    hash: bytes


class ChunkerBackend:
    """Contract: ``manifest(data) -> [ChunkRef...]``, batched over streams."""

    name = "abstract"

    def chunk(self, data) -> List[tuple]:
        raise NotImplementedError

    def digest_many(self, datas: Sequence[bytes]) -> List[bytes]:
        raise NotImplementedError

    # --- erasure coding: the numpy oracle by default; GpuBackend overrides
    # with the device product, and both are bit-identical ----------------

    def encode_shards(self, stripes, m: int):
        """Reed-Solomon parity: (B, k, L) data shards -> (B, m, L)."""
        stripes = np.asarray(stripes, dtype=np.uint8)
        b, k, ln = stripes.shape
        if m == 0 or b == 0:
            return np.zeros((b, m, ln), dtype=np.uint8)
        parity_rows = gf_cpu.generator_matrix(k, m)[k:]
        return np.stack([gf_cpu.gf_matmul(parity_rows, s) for s in stripes])

    def decode_shards(self, stripes, k: int, m: int, present):
        """Recover data shards from survivors: ``stripes`` is (B, k, L)
        with rows ordered by the sorted ``present`` indices."""
        stripes = np.asarray(stripes, dtype=np.uint8)
        if stripes.shape[0] == 0:
            return stripes
        cols = sorted(set(int(i) for i in present))
        rec = gf_cpu.decode_matrix(k, m, cols)[:, cols]
        return np.stack([gf_cpu.gf_matmul(rec, s) for s in stripes])

    def manifest_many(self, streams: Sequence[bytes]) -> List[List[ChunkRef]]:
        """Chunk + fingerprint a batch of streams in one pipeline pass.

        Dispatch accounting (obs/profile.py, exact on the host path, as in
        the reference): one scan + one select per stream, one gather per
        stream that produced chunks, one batched digest per call with
        pieces."""
        all_chunks = []  # (stream_idx, offset, length)
        pieces = []
        for i, data in enumerate(streams):
            n = len(data)
            obs_profile.dispatch("scan", actual_bytes=n, padded_bytes=n)
            obs_profile.dispatch("select", actual_bytes=n, padded_bytes=n)
            gathered = 0
            for off, ln in self.chunk(data):
                all_chunks.append((i, off, ln))
                pieces.append(bytes(data[off:off + ln]))
                gathered += ln
            if gathered:
                obs_profile.dispatch("gather", actual_bytes=gathered,
                                     padded_bytes=gathered)
        if pieces:
            total = sum(len(p) for p in pieces)
            obs_profile.dispatch("digest", actual_bytes=total,
                                 padded_bytes=total)
        digests = self.digest_many(pieces)
        out: List[List[ChunkRef]] = [[] for _ in streams]
        for (i, off, ln), h in zip(all_chunks, digests):
            out[i].append(ChunkRef(offset=off, length=ln, hash=h))
        return out

    def manifest(self, data) -> List[ChunkRef]:
        return self.manifest_many([data])[0]

    def manifest_many_classified(self, streams: Sequence[bytes], dedup):
        """Manifest + dedup-classify one batch in a single call.

        Returns ``(manifests, hints)`` where ``hints`` aligns with the
        flattened refs (row-major over streams): the packer's dup-hint
        contract.  Base backends run the two passes back to back against
        ``dedup.classify_insert``; :class:`GpuBackend` overrides it with
        the on-device handoff."""
        out = self.manifest_many(streams)
        hashes = [r.hash for refs in out for r in refs]
        if hashes:
            obs_profile.dispatch("index", actual_bytes=32 * len(hashes),
                                 padded_bytes=32 * len(hashes))
        return out, dedup.classify_insert(hashes)

    def manifest_stream(self, read: Callable[[int], bytes],
                        segment_bytes: int = 256 * 1024 * 1024,
                        emit: Optional[Callable] = None) -> List[ChunkRef]:
        """Chunk + fingerprint a stream without holding it in memory.

        ``read(n)`` returns up to ``n`` bytes (empty at EOF).  A CDC cut
        depends only on bytes up to the cut, so chunking a prefix gives
        final chunks except the last, which is carried into the next
        segment; the result equals chunking the whole stream at once.
        ``emit(ref, chunk_bytes)`` fires per final chunk.
        """
        out: List[ChunkRef] = []
        carry = b""
        base = 0  # absolute offset of carry[0]
        while True:
            segment = read(segment_bytes)
            eof = not segment
            buf = carry + segment
            chunks = self.chunk(buf)
            obs_profile.dispatch("scan", actual_bytes=len(buf),
                                 padded_bytes=len(buf))
            obs_profile.dispatch("select", actual_bytes=len(buf),
                                 padded_bytes=len(buf))
            if eof:
                final, carry, next_base = chunks, b"", base
            elif len(chunks) > 1:
                final = chunks[:-1]
                last_off = chunks[-1][0]
                carry, next_base = buf[last_off:], base + last_off
            else:
                # single chunk that may still grow: carry everything
                final, carry, next_base = [], buf, base
            pieces = [buf[off:off + ln] for off, ln in final]
            if pieces:
                total = sum(len(p) for p in pieces)
                obs_profile.dispatch("gather", actual_bytes=total,
                                     padded_bytes=total)
                obs_profile.dispatch("digest", actual_bytes=total,
                                     padded_bytes=total)
            for h, (off, ln), data in zip(self.digest_many(pieces), final,
                                          pieces):
                ref = ChunkRef(offset=base + off, length=ln, hash=h)
                out.append(ref)
                if emit is not None:
                    emit(ref, data)
            base = next_base
            if eof:
                break
        return out


class CpuBackend(ChunkerBackend):
    """The numpy oracle: ``cdc_cpu`` chunking + ``blake3_cpu`` digests."""

    name = "cpu"

    def __init__(self, params: Optional[CDCParams] = None):
        self.params = params or CDCParams()

    def chunk(self, data):
        return chunk_stream_cpu(data, self.params)

    def digest_many(self, datas):
        return blake3_many(datas)


class GpuBackend(ChunkerBackend):
    """Device execution: ``manifest_many`` stages each batch on the device
    once and runs scan -> cut selection -> leaf-pool digest there
    (:meth:`.pipeline.DevicePipeline.manifest_batch`).  ``device=None``
    means CUDA and raises without it; ``device="cpu"`` runs the plain
    PyTorch versions of the kernels.  ``strict_overflow`` makes any
    overflow re-run raise instead of being taken."""

    name = "gpu"

    def __init__(self, params: Optional[CDCParams] = None, device=None,
                 strict_overflow: bool = False):
        self.params = params or CDCParams()
        self.pipeline = DevicePipeline(self.params, device=device,
                                       strict_overflow=strict_overflow)
        self.device = self.pipeline.device

    def chunk(self, data):
        return self.pipeline.scanner.chunk_stream(data)

    def digest_many(self, datas):
        return blake3_many_gpu(datas, device=self.device)

    def encode_shards(self, stripes, m):
        return rs_gpu.encode_stripes(stripes, m, device=self.device)

    def decode_shards(self, stripes, k, m, present):
        return rs_gpu.decode_stripes(stripes, k, m, present,
                                     device=self.device)

    def manifest_many(self, streams):
        return [_refs(chunks, digests)
                for chunks, digests in self.pipeline.manifest_batch(streams)]

    def manifest_many_classified(self, streams, dedup):
        """One pass: each batch's digest accumulator feeds the device dedup
        table (``dedup.classify_dispatch``) without a host round trip, and
        the downloaded found-flags become the dup hints through
        ``dedup.resolve_hints``.  Falls back to the two-pass base only
        when ``dedup`` has no device handoff."""
        if getattr(dedup, "classify_dispatch", None) is None:
            return super().manifest_many_classified(streams, dedup)
        results, rowflags = self.pipeline.manifest_batch_classified(
            streams, dedup)
        out = []
        hashes: List[bytes] = []
        raw: List[Optional[bool]] = []
        for (chunks, digests), fl in zip(results, rowflags):
            refs = _refs(chunks, digests)
            out.append(refs)
            for k, ref in enumerate(refs):
                hashes.append(ref.hash)
                raw.append(None if fl is None else bool(fl[k]))
        return out, dedup.resolve_hints(hashes, raw)


def _refs(chunks, digests) -> List[ChunkRef]:
    return [ChunkRef(offset=off, length=ln, hash=digests[k].tobytes())
            for k, (off, ln) in enumerate(chunks)]


def select_backend(prefer: Optional[str] = None,
                   params: Optional[CDCParams] = None) -> ChunkerBackend:
    """``prefer`` in {"gpu", "cpu", None}; ``None`` means the GPU, which
    raises when CUDA is missing (the port never drops to the CPU by
    itself)."""
    if prefer == "cpu":
        return CpuBackend(params)
    if prefer in (None, "gpu"):
        return GpuBackend(params)
    raise ValueError(f"unknown backend {prefer!r}")
