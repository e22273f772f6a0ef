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
device dedup table mid-manifest.  Erasure coding is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

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

    def manifest_many(self, streams: Sequence[bytes]) -> List[List[ChunkRef]]:
        """Chunk + fingerprint a batch of streams."""
        all_chunks = []  # (stream_idx, offset, length)
        pieces = []
        for i, data in enumerate(streams):
            for off, ln in self.chunk(data):
                all_chunks.append((i, off, ln))
                pieces.append(bytes(data[off:off + ln]))
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
        return out, dedup.classify_insert([r.hash for refs in out
                                           for r in refs])

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
