"""Tunables of the port's backup data plane.

The port's own copies of the constants it needs from
``backuwup_tpu/defaults.py``; the port imports nothing of the JAX package.
"""

KiB = 1024
MiB = 1024 * KiB

# --- content-defined chunking (reference client/src/defaults.rs:62-68) ------
CDC_MIN_CHUNK = 256 * KiB
CDC_DESIRED_CHUNK = 1 * MiB
CDC_MAX_CHUNK = 3 * MiB

# Normalized-chunking mask widths (FastCDC 2020, normalization level 2):
# below the desired size a stricter mask applies, above it a looser one.
CDC_MASK_S_BITS = 22  # desired 2**20 => 20 + 2
CDC_MASK_L_BITS = 18  # 20 - 2

# Leaf bucket sizes (in 1 KiB blake3 chunks) used when batching variable-size
# inputs for fingerprinting; inputs are padded up to the nearest bucket.
BLAKE3_LEAF_BUCKETS = (16, 64, 256, 1024, 2048, 3072)

# --- device dedup table (backuwup_tpu/defaults.py:428-429) -------------------
# slots per shard (16 B key + 4 B value each) and linear-probe steps
DEDUP_SHARD_CAPACITY = 1 << 20
DEDUP_MAX_PROBES = 32

# --- packfiles (backuwup_tpu/defaults.py:25-34; reference packfile/mod.rs) ---
PACKFILE_TARGET_SIZE = 3 * MiB
PACKFILE_MAX_SIZE = 16 * MiB
PACKFILE_MAX_BLOBS = 100_000
ZSTD_COMPRESSION_LEVEL = 3
# blob-index entries per encrypted index file (blob_index.rs:16-19)
INDEX_FILE_MAX_ENTRIES = 50_000
# children per tree node before a next_sibling page (dir_packer.rs:35)
TREE_MAX_CHILDREN = 10_000

# --- packfile seal pipeline (backuwup_tpu/defaults.py:96-102) ----------------
# worker threads running zstd + AES-GCM (both release the GIL), the bound on
# assembled-but-unwritten packfile batches, and the packer's lag bound on
# blobs buffered below the packfile target size
PACK_SEAL_WORKERS = 2
PACK_SEAL_QUEUE_PACKFILES = 2
PACK_EMIT_MAX_LAG_S = 2.0

# --- p2p transport (backuwup_tpu/defaults.py:183-191) ------------------------
# every packfile must fit one signed transport message, so the writer's cap
# is the wire maximum less the envelope's framing
MAX_P2P_MESSAGE_SIZE = 8 * MiB
P2P_ENVELOPE_OVERHEAD = 4 * KiB
PACKFILE_WIRE_MAX = MAX_P2P_MESSAGE_SIZE - P2P_ENVELOPE_OVERHEAD

# --- event journal (backuwup_tpu/defaults.py:210-212) ------------------------
OBS_JOURNAL_MAX_BYTES = 4 * MiB  # rotate the JSONL journal past this size
OBS_JOURNAL_KEEP = 3  # rotated generations retained (<path>.1 .. .keep)
OBS_PANIC_TAIL_LINES = 200  # journal lines embedded in a panic dump

# --- tiered dedup index (backuwup_tpu/defaults.py:436-447) -------------------
# Ceiling on device bytes the hot fingerprint table may occupy: slots x 20
# bytes (16-byte truncated key + u32 value) x shards.  When an insert would
# force a 4x growth past it, the tiered index demotes cold fingerprints to
# the host LSM store instead of growing.
DEDUP_HBM_BUDGET_BYTES = 256 * MiB
# cold-tier LSM store: memtable entries before a sorted run is committed,
# prefix buckets per run, and the size-tiered compaction fan-in
DEDUP_COLD_MEMTABLE_LIMIT = 1 << 16
DEDUP_COLD_BUCKETS = 256
DEDUP_COLD_COMPACT_FANIN = 4
# promotion clock: one period every this many classify windows; cold
# fingerprints hit at least PROMOTE_MIN_HITS times in a period are promoted
DEDUP_TIER_CLOCK_WINDOWS = 8
DEDUP_TIER_PROMOTE_MIN_HITS = 2

# --- erasure-coded stripes (backuwup_tpu/defaults.py:73-79) -----------------
# Each sealed packfile is split into RS_K data shards plus RS_M parity
# shards (systematic GF(2^8) Reed-Solomon); any RS_K of the RS_K+RS_M
# shards reconstruct the packfile.
RS_K = 4
RS_M = 2

# --- peer storage quota and receiver partials (backuwup_tpu/defaults.py:45,
# :309) ----------------------------------------------------------------------
PEER_OVERUSE_GRACE = 16 * MiB  # tolerated overshoot per peer
# a receiver-side partial transfer untouched for this long is abandoned
PARTIAL_STORE_TTL_S = 24 * 3600.0

# --- unified retry policies (backuwup_tpu/defaults.py:49-64) -----------------
RETRY_JITTER = 0.1  # default +/- fraction applied to every delay
DIAL_RETRY_BASE_S = 0.5
DIAL_RETRY_CAP_S = 2.0
DIAL_RETRY_ATTEMPTS = 2  # retries after the first dial (3 dials total)
WS_RECONNECT_BASE_S = 0.2
WS_RECONNECT_CAP_S = 30.0
STORAGE_REQUEST_RETRY_S = 10.0
STORAGE_REQUEST_RETRY_CAP_S = 60.0
SEND_IDLE_BASE_S = 0.05
SEND_IDLE_CAP_S = 0.25
PEER_WAIT_BASE_S = 0.2
PEER_WAIT_CAP_S = 1.0

# --- capacity-aware placement (backuwup_tpu/defaults.py:131, :164-176) -------
# Peers are ranked by log2-bucketed (EWMA throughput x success ratio) with
# free space as the tiebreak; a peer needs this many samples before its
# measurement outranks the neutral prior, so fresh peers stay schedulable.
TRANSFER_MIN_THROUGHPUT_BPS = 256 * KiB
PLACEMENT_MIN_SAMPLES = 3
PLACEMENT_NEUTRAL_SCORE_BPS = TRANSFER_MIN_THROUGHPUT_BPS
# a placement-demoted peer gets another chance after this long
PLACEMENT_PROBATION_S = 600.0

# --- storage attestation (backuwup_tpu/defaults.py:194-202) ------------------
AUDIT_CHALLENGES_PER_PACKFILE = 16  # precomputed table entries per packfile
AUDIT_WINDOW_BYTES = 64 * KiB  # sampled window length (clamped to file size)
AUDIT_SAMPLES_PER_ROUND = 8  # challenges issued per peer per audit round
AUDIT_INTERVAL_S = 6 * 3600.0  # healthy-peer re-audit cadence
AUDIT_RETRY_BASE_S = 60.0  # first retry delay after a miss/failure
AUDIT_BACKOFF_CAP_S = 24 * 3600.0  # exponential-backoff ceiling
AUDIT_DEMOTE_MISSES = 3  # consecutive offline windows before demotion
AUDIT_DEMOTE_FAILURES = 1  # confirmed bad/missing proofs before demotion
