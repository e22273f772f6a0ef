"""L0 wire types: IDs, nonces, hashes, blob/tree model, protocol messages.

Counterpart of ``backuwup_tpu/wire.py``, copied so that the port imports
nothing of the JAX package; what it writes is byte-identical.

Re-designs the reference ``shared/`` crate (``shared/src/types.rs:4-37``,
``shared/src/client_message.rs``, ``shared/src/server_message.rs``,
``shared/src/server_message_ws.rs``, ``shared/src/p2p_message.rs``) and the
client blob model (``client/src/backup/filesystem/mod.rs:14-105``) as plain
dataclasses plus a deterministic binary codec (:mod:`backuwup_tpu_torch.utils.serialization`).

Control-plane messages travel as JSON (``to_json``/``from_json``); data-plane
blobs/trees/p2p bodies travel in the binary codec, mirroring the reference's
serde_json-vs-bincode split (SURVEY.md section 2.5).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional

from .utils.serialization import Reader, Writer

# --- fixed-size value types (reference shared/src/types.rs:4-37) ------------
CLIENT_ID_LEN = 32  # Ed25519 public key doubles as the client identity
BLOB_HASH_LEN = 32  # blake3 digest
PACKFILE_ID_LEN = 12  # doubles as the packfile header AES-GCM nonce
SHARD_ID_LEN = PACKFILE_ID_LEN + 1  # packfile id + erasure shard index byte
SESSION_TOKEN_LEN = 16
TRANSPORT_NONCE_LEN = 16
CHALLENGE_NONCE_LEN = 32
AUDIT_NONCE_LEN = 16  # per-window keyed-digest nonce (storage attestation)


def _check(name: str, value: bytes, length: int) -> bytes:
    if not isinstance(value, (bytes, bytearray)) or len(value) != length:
        raise ValueError(f"{name} must be exactly {length} bytes, got {value!r:.60}")
    return bytes(value)


def _check_storage_id(name: str, value: bytes) -> bytes:
    """A storage-plane object id: a whole packfile (12 bytes) or one
    erasure shard (packfile id + index byte, 13 bytes)."""
    if (not isinstance(value, (bytes, bytearray))
            or len(value) not in (PACKFILE_ID_LEN, SHARD_ID_LEN)):
        raise ValueError(
            f"{name} must be {PACKFILE_ID_LEN} or {SHARD_ID_LEN} bytes, "
            f"got {value!r:.60}")
    return bytes(value)


class BlobKind(IntEnum):
    """reference client/src/backup/filesystem/mod.rs:14-18."""

    FILE_CHUNK = 0
    TREE = 1


class CompressionKind(IntEnum):
    """reference client/src/backup/filesystem/mod.rs:20-24 (Zstd added Zlib
    fallback for hosts without libzstd)."""

    NONE = 0
    ZSTD = 1
    ZLIB = 2


class TreeKind(IntEnum):
    FILE = 0
    DIR = 1


@dataclass(frozen=True)
class Blob:
    """An unencrypted unit of backup data (mod.rs:37-43)."""

    hash: bytes
    kind: BlobKind
    data: bytes

    def __post_init__(self) -> None:
        _check("blob hash", self.hash, BLOB_HASH_LEN)


@dataclass(frozen=True)
class PackfileHeaderBlob:
    """Per-blob entry of a packfile header (mod.rs:26-35)."""

    hash: bytes
    kind: BlobKind
    compression: CompressionKind
    length: int  # encrypted (nonce + ciphertext) byte length
    offset: int  # offset into the blob section

    def encode(self, w: Writer) -> None:
        w.fixed(_check("packfile blob hash", self.hash, BLOB_HASH_LEN))
        w.u32(int(self.kind))
        w.u32(int(self.compression))
        w.u64(self.length)
        w.u64(self.offset)

    @classmethod
    def decode(cls, r: Reader) -> "PackfileHeaderBlob":
        return cls(
            hash=r.fixed(BLOB_HASH_LEN),
            kind=BlobKind(r.u32()),
            compression=CompressionKind(r.u32()),
            length=r.u64(),
            offset=r.u64(),
        )


@dataclass(frozen=True)
class TreeMetadata:
    """reference mod.rs:76-81."""

    size: int = 0
    mtime_ns: int = 0
    ctime_ns: int = 0

    def encode(self, w: Writer) -> None:
        w.u64(self.size)
        w.u64(self.mtime_ns)
        w.u64(self.ctime_ns)

    @classmethod
    def decode(cls, r: Reader) -> "TreeMetadata":
        return cls(size=r.u64(), mtime_ns=r.u64(), ctime_ns=r.u64())


@dataclass
class Tree:
    """A directory or file node blob (reference mod.rs:62-74).

    ``children`` of a DIR tree are hashes of child Tree blobs; ``children`` of
    a FILE tree are hashes of its FILE_CHUNK blobs in order.  A node with more
    than TREE_MAX_CHILDREN children is split, the continuation linked through
    ``next_sibling`` (reference dir_packer.rs:313-363).
    """

    kind: TreeKind
    name: str
    metadata: TreeMetadata
    children: list = field(default_factory=list)
    next_sibling: Optional[bytes] = None

    def encode_bytes(self) -> bytes:
        w = Writer()
        w.u32(int(self.kind))
        w.str(self.name)
        self.metadata.encode(w)
        w.u64(len(self.children))
        for c in self.children:
            w.fixed(_check("tree child hash", c, BLOB_HASH_LEN))
        w.opt_fixed(self.next_sibling, BLOB_HASH_LEN)
        return w.take()

    @classmethod
    def decode_bytes(cls, buf: bytes) -> "Tree":
        r = Reader(buf)
        kind = TreeKind(r.u32())
        name = r.str()
        metadata = TreeMetadata.decode(r)
        children = [r.fixed(BLOB_HASH_LEN) for _ in range(r.u64())]
        next_sibling = r.opt_fixed(BLOB_HASH_LEN)
        r.expect_end()
        return cls(kind=kind, name=name, metadata=metadata, children=children,
                   next_sibling=next_sibling)


# --- control-plane JSON messages (reference shared/src/client_message.rs,
#     server_message.rs, server_message_ws.rs) -------------------------------


def _hex(b: Optional[bytes]) -> Optional[str]:
    return None if b is None else bytes(b).hex()


def _unhex(s: Optional[str], length: Optional[int], name: str) -> Optional[bytes]:
    if s is None:
        return None
    b = bytes.fromhex(s)
    return b if length is None else _check(name, b, length)


class JsonMessage:
    """Tagged-JSON base: ``{"t": <class name>, ...fields}``.

    Byte fields are declared via ``_bytes_fields = {name: length}`` (length
    ``None`` = variable) and hex-encoded on the wire.
    """

    _bytes_fields: dict = {}
    _registry: dict = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        JsonMessage._registry[cls.__name__] = cls

    def to_json(self) -> str:
        out = {"t": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in self._bytes_fields:
                v = _hex(v)
            out[f.name] = v
        return json.dumps(out, separators=(",", ":"), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "JsonMessage":
        obj = json.loads(s)
        tag = obj.pop("t", None)
        cls = JsonMessage._registry.get(tag)
        if cls is None:
            raise ValueError(f"unknown message tag {tag!r}")
        kw = {}
        for f in dataclasses.fields(cls):
            v = obj.get(f.name)
            if v is None:
                # Fields without a dataclass default are required: reject
                # missing/null so untrusted input can't construct half-built
                # protocol messages.
                required = (f.default is dataclasses.MISSING
                            and f.default_factory is dataclasses.MISSING)
                if required:
                    raise ValueError(f"{tag}: missing required field {f.name!r}")
                continue
            if f.name in cls._bytes_fields:
                if not isinstance(v, str):
                    raise ValueError(f"{tag}: field {f.name!r} must be a hex string")
                v = _unhex(v, cls._bytes_fields[f.name], f.name)
            kw[f.name] = v
        return cls(**kw)


# client -> server (reference shared/src/client_message.rs:9-77)

@dataclass
class ClientRegistrationRequest(JsonMessage):
    pubkey: bytes
    _bytes_fields = {"pubkey": CLIENT_ID_LEN}


@dataclass
class ClientRegistrationAuth(JsonMessage):
    pubkey: bytes
    challenge_response: bytes  # signature over the challenge nonce
    _bytes_fields = {"pubkey": CLIENT_ID_LEN, "challenge_response": None}


@dataclass
class ClientLoginRequest(JsonMessage):
    pubkey: bytes
    _bytes_fields = {"pubkey": CLIENT_ID_LEN}


@dataclass
class ClientLoginAuth(JsonMessage):
    pubkey: bytes
    challenge_response: bytes
    _bytes_fields = {"pubkey": CLIENT_ID_LEN, "challenge_response": None}


@dataclass
class BackupRequest(JsonMessage):
    # min_peers > 1 asks matchmaking to spread the grant over at least
    # that many distinct peers (erasure stripes need k+m distinct
    # holders); 1 keeps the reference's fill-greedily behavior.
    session_token: bytes
    storage_required: int
    min_peers: int = 1
    _bytes_fields = {"session_token": SESSION_TOKEN_LEN}


@dataclass
class BeginP2PConnectionRequest(JsonMessage):
    session_token: bytes
    destination_client_id: bytes
    session_nonce: bytes
    _bytes_fields = {
        "session_token": SESSION_TOKEN_LEN,
        "destination_client_id": CLIENT_ID_LEN,
        "session_nonce": TRANSPORT_NONCE_LEN,
    }


@dataclass
class ConfirmP2PConnectionRequest(JsonMessage):
    session_token: bytes
    source_client_id: bytes
    destination_ip_address: str
    _bytes_fields = {"session_token": SESSION_TOKEN_LEN,
                     "source_client_id": CLIENT_ID_LEN}


@dataclass
class BackupRestoreRequest(JsonMessage):
    session_token: bytes
    _bytes_fields = {"session_token": SESSION_TOKEN_LEN}


@dataclass
class BackupDone(JsonMessage):
    session_token: bytes
    snapshot_hash: bytes
    _bytes_fields = {"session_token": SESSION_TOKEN_LEN,
                     "snapshot_hash": BLOB_HASH_LEN}


@dataclass
class AuditReport(JsonMessage):
    """Client -> server: outcome of one storage-attestation round against
    ``peer_id`` (no reference equivalent; see docs/audit.md).  The server
    aggregates reports across verifiers to adjust matchmaking."""

    session_token: bytes
    peer_id: bytes
    passed: bool
    detail: str = ""
    _bytes_fields = {"session_token": SESSION_TOKEN_LEN,
                     "peer_id": CLIENT_ID_LEN}


@dataclass
class RepairReport(JsonMessage):
    """Client -> server: one repair round re-replicated the placements a
    lost ``peer_id`` held for us (no reference equivalent; see
    docs/failure_model.md).  The server retires the negotiation edges so
    restore peer lists stop naming the dead peer, and records the event
    for allocation accounting."""

    session_token: bytes
    peer_id: bytes
    packfiles_lost: int
    bytes_lost: int
    bytes_replaced: int
    _bytes_fields = {"session_token": SESSION_TOKEN_LEN,
                     "peer_id": CLIENT_ID_LEN}


# server -> client HTTP responses (reference shared/src/server_message.rs:9-54)

@dataclass
class Ok(JsonMessage):
    pass


@dataclass
class ServerChallenge(JsonMessage):
    nonce: bytes
    _bytes_fields = {"nonce": CHALLENGE_NONCE_LEN}


@dataclass
class LoginToken(JsonMessage):
    token: bytes
    _bytes_fields = {"token": SESSION_TOKEN_LEN}


@dataclass
class BackupRestoreInfo(JsonMessage):
    # rs_k/rs_m advertise the erasure geometry the cluster runs (0 = the
    # server predates sharding); shard containers are self-describing, so
    # these are informational for the restoring client's planning only.
    snapshot_hash: Optional[bytes] = None
    peers: list = field(default_factory=list)  # hex client ids
    rs_k: int = 0
    rs_m: int = 0
    _bytes_fields = {"snapshot_hash": BLOB_HASH_LEN}


class ErrorKind:
    """The closed error taxonomy, mirroring the reference's 8 ``ErrorType``
    variants (shared/src/server_message.rs:43-54); payload details ride in
    :class:`Error.detail` (the reference embeds strings in three of them).
    """

    UNAUTHORIZED = "Unauthorized"
    CLIENT_NOT_FOUND = "ClientNotFound"
    DESTINATION_UNREACHABLE = "DestinationUnreachable"
    NO_BACKUPS = "NoBackups"
    RETRY = "Retry"
    BAD_REQUEST = "BadRequest"
    SERVER_ERROR = "ServerError"
    FAILURE = "Failure"

    ALL = (UNAUTHORIZED, CLIENT_NOT_FOUND, DESTINATION_UNREACHABLE,
           NO_BACKUPS, RETRY, BAD_REQUEST, SERVER_ERROR, FAILURE)


# kind -> HTTP status, per the reference's ResponseError mapping
# (server/src/handlers/mod.rs:50-91); ClientExists keeps the reference's
# 409 CONFLICT status with a BAD_REQUEST payload.
ERROR_HTTP_STATUS = {
    ErrorKind.UNAUTHORIZED: 401,
    ErrorKind.CLIENT_NOT_FOUND: 404,
    ErrorKind.DESTINATION_UNREACHABLE: 404,
    ErrorKind.NO_BACKUPS: 404,
    ErrorKind.RETRY: 404,
    ErrorKind.BAD_REQUEST: 400,
    ErrorKind.SERVER_ERROR: 500,
    ErrorKind.FAILURE: 500,
}


@dataclass
class NodeRedirect(JsonMessage):
    """server -> client, HTTP 421: this pubkey's home is another
    coordination node (federation wrong-node arrival; no reference
    equivalent — the reference has exactly one server).  ``url`` is the
    owning node's base URL; clients follow at most one redirect per
    request and only toward a URL already on their configured node
    list."""

    url: str = ""


@dataclass
class Error(JsonMessage):
    # one of ErrorKind.ALL plus a human-readable detail
    kind: str = ErrorKind.FAILURE
    detail: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ErrorKind.ALL:
            self.detail = (f"{self.kind}: {self.detail}"
                           if self.detail else self.kind)
            self.kind = ErrorKind.FAILURE


# server -> client WS push (reference shared/src/server_message_ws.rs:9-35)

@dataclass
class Ping(JsonMessage):
    pass


@dataclass
class BackupMatched(JsonMessage):
    destination_id: bytes
    storage_available: int
    _bytes_fields = {"destination_id": CLIENT_ID_LEN}


@dataclass
class IncomingP2PConnection(JsonMessage):
    source_client_id: bytes
    session_nonce: bytes
    _bytes_fields = {"source_client_id": CLIENT_ID_LEN,
                     "session_nonce": TRANSPORT_NONCE_LEN}


@dataclass
class FinalizeP2PConnection(JsonMessage):
    destination_client_id: bytes
    destination_ip_address: str
    _bytes_fields = {"destination_client_id": CLIENT_ID_LEN}


@dataclass
class AuditDue(JsonMessage):
    """Server -> client WS scheduling nudge: another verifier reported
    ``peer_id`` failing its storage audit — clients holding data there
    should audit it soon rather than waiting out their normal interval."""

    peer_id: bytes
    _bytes_fields = {"peer_id": CLIENT_ID_LEN}


# --- p2p data-plane messages (reference shared/src/p2p_message.rs) ----------

class RequestType(IntEnum):
    """p2p_message.rs:36-39 (AUDIT added for storage attestation,
    RESTORE_FETCH for shard-granular pull restore — docs/transfer.md
    restore data plane)."""

    TRANSPORT = 0
    RESTORE_ALL = 1
    AUDIT = 2
    RESTORE_FETCH = 3
    # GC's make-before-break tail: the owner asks a holder to delete
    # superseded packfiles/shards it placed there (docs/lifecycle.md)
    RECLAIM = 4


class FileInfoKind(IntEnum):
    """p2p_message.rs:51-54 (SHARD added for erasure-coded placement:
    the file_id is a 13-byte shard id and the payload a self-describing
    shard container, erasure/stripe.py)."""

    PACKFILE = 0
    INDEX = 1
    SHARD = 2


@dataclass(frozen=True)
class P2PHeader:
    """Replay-protection header (p2p_message.rs:21-24)."""

    sequence_number: int
    session_nonce: bytes

    def encode(self, w: Writer) -> None:
        w.u64(self.sequence_number)
        w.fixed(_check("session nonce", self.session_nonce, TRANSPORT_NONCE_LEN))

    @classmethod
    def decode(cls, r: Reader) -> "P2PHeader":
        return cls(sequence_number=r.u64(), session_nonce=r.fixed(TRANSPORT_NONCE_LEN))


class P2PBodyKind(IntEnum):
    REQUEST = 0
    FILE = 1
    ACK = 2
    CHALLENGE = 3  # storage-attestation challenge batch
    PROOF = 4  # storage-attestation proof batch
    # resumable chunked transfer (docs/transfer.md resume protocol).
    # FILE frames stay on the wire unchanged, so peers that only speak
    # the whole-file path keep interoperating; the three kinds below are
    # additive.
    FILE_PART = 5  # one byte range of a file, acked like FILE
    RESUME_QUERY = 6  # sender asks: how much of file_id do you hold?
    RESUME_OFFER = 7  # receiver's answer, echoing the query's sequence
    # shard-granular pull restore (docs/transfer.md restore data plane).
    # Additive like the resume trio: only sent on RESTORE_FETCH sessions,
    # which old peers never accept, so RESTORE_ALL interop is untouched.
    FETCH_REQUEST = 8  # puller names the stored items it wants
    # GC reclaim (docs/lifecycle.md).  Additive like FETCH_REQUEST: only
    # sent on RECLAIM sessions, which old peers never accept.  The
    # request reuses the (FileInfoKind, file_id) pair shape of wants;
    # the ack echoes the request's sequence number (the CHALLENGE/PROOF
    # correlation idiom) and reports bytes actually freed in ``offset``.
    RECLAIM_REQUEST = 9
    RECLAIM_ACK = 10


class ProofStatus(IntEnum):
    """Per-window prover outcome inside a PROOF body."""

    OK = 0
    MISSING = 1  # prover no longer holds the packfile at all
    SHORT = 2  # packfile present but shorter than the challenged window


@dataclass(frozen=True)
class StorageChallenge:
    """One random-window audit challenge: prove possession of
    ``packfile_id[offset:offset+length]`` by returning
    blake3(nonce || window-bytes).  The id names a whole packfile
    (12 bytes) or a single erasure shard (13 bytes), so the id is
    length-prefixed on the wire."""

    packfile_id: bytes
    offset: int
    length: int
    nonce: bytes

    def __post_init__(self) -> None:
        _check_storage_id("challenge packfile id", self.packfile_id)
        _check("challenge nonce", self.nonce, AUDIT_NONCE_LEN)

    def encode(self, w: Writer) -> None:
        w.blob(self.packfile_id)
        w.u64(self.offset)
        w.u64(self.length)
        w.fixed(self.nonce)

    @classmethod
    def decode(cls, r: Reader) -> "StorageChallenge":
        return cls(packfile_id=r.blob(), offset=r.u64(),
                   length=r.u64(), nonce=r.fixed(AUDIT_NONCE_LEN))


@dataclass(frozen=True)
class StorageProof:
    """The prover's answer to one :class:`StorageChallenge` (digest is
    all-zero when status != OK)."""

    packfile_id: bytes
    status: ProofStatus
    digest: bytes = b"\x00" * BLOB_HASH_LEN

    def __post_init__(self) -> None:
        _check_storage_id("proof packfile id", self.packfile_id)
        _check("proof digest", self.digest, BLOB_HASH_LEN)

    def encode(self, w: Writer) -> None:
        w.blob(self.packfile_id)
        w.u32(int(self.status))
        w.fixed(self.digest)

    @classmethod
    def decode(cls, r: Reader) -> "StorageProof":
        return cls(packfile_id=r.blob(),
                   status=ProofStatus(r.u32()),
                   digest=r.fixed(BLOB_HASH_LEN))


@dataclass(frozen=True)
class P2PBody:
    """Union of the signed p2p body kinds (p2p_message.rs:27-61 plus the
    attestation pair): connection-init request (seq 0), file payload, ack,
    audit challenge batch, audit proof batch."""

    kind: P2PBodyKind
    header: P2PHeader
    request_type: Optional[RequestType] = None  # REQUEST
    file_info: Optional[FileInfoKind] = None  # FILE / FILE_PART / RESUME_QUERY
    file_id: bytes = b""  # FILE: packfile id or index number (LE bytes)
    data: bytes = b""  # FILE / FILE_PART payload
    acked_sequence: int = 0  # ACK
    challenges: tuple = ()  # CHALLENGE: StorageChallenge...
    proofs: tuple = ()  # PROOF: StorageProof...
    offset: int = 0  # FILE_PART: byte offset / RESUME_OFFER: verified bytes held / RECLAIM_ACK: bytes freed
    total_size: int = 0  # FILE_PART: whole-file length
    file_digest: bytes = b""  # FILE_PART / RESUME_OFFER: whole-file blake3
    prefix_digest: bytes = b""  # RESUME_OFFER: blake3 of the held prefix
    wants: tuple = ()  # FETCH_REQUEST / RECLAIM_REQUEST: (FileInfoKind, file_id) pairs

    def encode_bytes(self) -> bytes:
        w = Writer()
        w.u32(int(self.kind))
        self.header.encode(w)
        if self.kind == P2PBodyKind.REQUEST:
            w.u32(int(self.request_type))
        elif self.kind == P2PBodyKind.FILE:
            w.u32(int(self.file_info))
            w.blob(self.file_id)
            w.blob(self.data)
        elif self.kind == P2PBodyKind.ACK:
            w.u64(self.acked_sequence)
        elif self.kind == P2PBodyKind.CHALLENGE:
            w.u64(len(self.challenges))
            for c in self.challenges:
                c.encode(w)
        elif self.kind == P2PBodyKind.PROOF:
            w.u64(len(self.proofs))
            for p in self.proofs:
                p.encode(w)
        elif self.kind == P2PBodyKind.FILE_PART:
            w.u32(int(self.file_info))
            w.blob(self.file_id)
            w.u64(self.offset)
            w.u64(self.total_size)
            w.fixed(_check("file digest", self.file_digest, BLOB_HASH_LEN))
            w.blob(self.data)
        elif self.kind == P2PBodyKind.RESUME_QUERY:
            w.u32(int(self.file_info))
            w.blob(self.file_id)
        elif self.kind == P2PBodyKind.RESUME_OFFER:
            w.blob(self.file_id)
            w.u64(self.offset)
            # both digests are empty blobs when nothing is held
            w.blob(self.file_digest)
            w.blob(self.prefix_digest)
        elif self.kind in (P2PBodyKind.FETCH_REQUEST,
                           P2PBodyKind.RECLAIM_REQUEST):
            w.u64(len(self.wants))
            for fi, fid in self.wants:
                w.u32(int(fi))
                w.blob(fid)
        elif self.kind == P2PBodyKind.RECLAIM_ACK:
            w.u64(self.acked_sequence)
            w.u64(self.offset)  # bytes freed
        return w.take()

    @classmethod
    def decode_bytes(cls, buf: bytes) -> "P2PBody":
        r = Reader(buf)
        kind = P2PBodyKind(r.u32())
        header = P2PHeader.decode(r)
        kw = {}
        if kind == P2PBodyKind.REQUEST:
            kw["request_type"] = RequestType(r.u32())
        elif kind == P2PBodyKind.FILE:
            kw["file_info"] = FileInfoKind(r.u32())
            kw["file_id"] = r.blob()
            kw["data"] = r.blob()
        elif kind == P2PBodyKind.ACK:
            kw["acked_sequence"] = r.u64()
        elif kind == P2PBodyKind.CHALLENGE:
            kw["challenges"] = tuple(
                StorageChallenge.decode(r) for _ in range(r.u64()))
        elif kind == P2PBodyKind.PROOF:
            kw["proofs"] = tuple(
                StorageProof.decode(r) for _ in range(r.u64()))
        elif kind == P2PBodyKind.FILE_PART:
            kw["file_info"] = FileInfoKind(r.u32())
            kw["file_id"] = r.blob()
            kw["offset"] = r.u64()
            kw["total_size"] = r.u64()
            kw["file_digest"] = r.fixed(BLOB_HASH_LEN)
            kw["data"] = r.blob()
        elif kind == P2PBodyKind.RESUME_QUERY:
            kw["file_info"] = FileInfoKind(r.u32())
            kw["file_id"] = r.blob()
        elif kind == P2PBodyKind.RESUME_OFFER:
            kw["file_id"] = r.blob()
            kw["offset"] = r.u64()
            kw["file_digest"] = r.blob()
            kw["prefix_digest"] = r.blob()
        elif kind in (P2PBodyKind.FETCH_REQUEST,
                      P2PBodyKind.RECLAIM_REQUEST):
            kw["wants"] = tuple(
                (FileInfoKind(r.u32()), r.blob()) for _ in range(r.u64()))
        elif kind == P2PBodyKind.RECLAIM_ACK:
            kw["acked_sequence"] = r.u64()
            kw["offset"] = r.u64()
        r.expect_end()
        return cls(kind=kind, header=header, **kw)


@dataclass(frozen=True)
class EncapsulatedMsg:
    """Signed envelope for every p2p message (p2p_message.rs:12-17).

    ``trace_id`` is an optional trailing frame carrying the sender's
    observability trace id (obs/trace.py).  It sits OUTSIDE the signed
    body on purpose: it is advisory correlation metadata, never input to
    any decision, so it needs no authentication — and old peers that
    stop reading after the signature still interoperate (the field is
    only decoded when bytes remain)."""

    body: bytes  # encoded P2PBody
    signature: bytes  # Ed25519 signature over body
    trace_id: Optional[str] = None  # unauthenticated, advisory

    def encode_bytes(self) -> bytes:
        w = Writer()
        w.blob(self.body)
        w.blob(self.signature)
        if self.trace_id:
            w.str(self.trace_id)
        return w.take()

    @classmethod
    def decode_bytes(cls, buf: bytes) -> "EncapsulatedMsg":
        r = Reader(buf)
        body = r.blob()
        sig = r.blob()
        trace_id = None
        if r.remaining():
            tid = r.str()
            if len(tid) <= 32 and all(c in "0123456789abcdef" for c in tid):
                trace_id = tid or None
        r.expect_end()
        return cls(body=body, signature=sig, trace_id=trace_id)
