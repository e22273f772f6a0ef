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

# --- send pipeline and timeouts (backuwup_tpu/defaults.py:39-42, :59, :69) --
PACKFILE_SEND_TIMEOUT_S = 20.0
ACK_TIMEOUT_S = 5.0
RESTORE_REQUEST_THROTTLE_S = 60.0
# grace given to in-flight handlers when a coordination node stops
SERVER_SHUTDOWN_GRACE_S = 2.0
# a peer unseen for this long is treated as lost (:70)
PEER_DARK_DEADLINE_S = 3 * 24 * 3600.0

# --- concurrent transfer plane (backuwup_tpu/defaults.py:85, :91) -----------
# uploads admitted concurrently across all peers, and the in-flight payload
# RAM cap (a single larger transfer is still admitted when the plane is empty)
TRANSFER_MAX_INFLIGHT = 8
TRANSFER_INFLIGHT_BYTE_CAP = 64 * MiB

# --- resumable WAN transfer plane (backuwup_tpu/defaults.py:117-133) ---------
# payloads larger than this go out as FILE_PART frames with per-part acks
# after a RESUME_QUERY; 0 disables chunking
TRANSFER_CHUNK_BYTES = 1 * MiB
TRANSFER_RESUME_ATTEMPTS = 2
TRANSFER_RESUME_ENABLED = True
# adaptive per-transfer deadline: ACK_TIMEOUT_S + size / floor, floor the
# larger of the minimum link rate and the peer's EWMA derated by the safety
# fraction, capped
TRANSFER_DEADLINE_SAFETY = 0.25
TRANSFER_DEADLINE_CAP_S = 600.0

# --- restore data plane (backuwup_tpu/defaults.py:154-157) ------------------
# serve-side throttle of RESTORE_FETCH sessions (off by default) and the
# bound on items one FETCH_REQUEST may name
RESTORE_FETCH_MIN_INTERVAL_S = 0.0
RESTORE_FETCH_MAX_WANTS = 4096

# --- placement demotion (backuwup_tpu/defaults.py:173-175) -------------------
PLACEMENT_DEMOTE_SUCCESS = 0.25
PLACEMENT_RECOVER_SUCCESS = 0.6
PLACEMENT_DEMOTE_MIN_SAMPLES = 4

# --- protocol limits (backuwup_tpu/defaults.py:179-180) ----------------------
MAX_BACKUP_STORAGE_REQUEST_SIZE = 16 * 1024 * MiB
BACKUP_REQUEST_EXPIRY_S = 300.0

# --- audit serving and reporting (backuwup_tpu/defaults.py:197, :203-206) ----
AUDIT_MAX_CHALLENGES_PER_MSG = 256  # prover-side cap on one CHALLENGE body
AUDIT_PROOF_TIMEOUT_S = 15.0  # verifier wait for the PROOF body
AUDIT_SERVE_MIN_INTERVAL_S = 5.0  # prover-side per-peer rate limit
AUDIT_SERVER_BLOCK_FAILURES = 2  # distinct failing verifiers to block matches
AUDIT_REPORT_WINDOW_S = 24 * 3600.0  # server aggregation window

# --- peer stats (backuwup_tpu/defaults.py:217) -------------------------------
# EWMA weight of each new TransferResult in the per-peer estimators
PEER_STATS_ALPHA = 0.2

# --- live SLO plane (backuwup_tpu/defaults.py:240-291) -----------------------
# multi-window burn alerts and the objective catalog that obs/slo.py reads
SLO_WINDOWS = ((300.0, 3600.0), (21600.0, 259200.0))
SLO_FAST_BURN = 14.4
SLO_SLOW_BURN = 6.0
SLO_CATALOG = (
    {"id": "durability", "kind": "counter_rate",
     "family": "bkw_durability_violation_seconds_total", "labels": {},
     "budget": 0.001,
     "description": "fraction of time any durability invariant is"
                    " violated stays ~0"},
    {"id": "transfer_stalls", "kind": "ratio",
     "family": "bkw_transfer_stalls_total", "labels": {},
     "total_family": "bkw_transfers_total", "budget": 0.02,
     "description": "adaptive-deadline stall aborts per completed"
                    " transfer"},
    {"id": "backup_p99", "kind": "quantile",
     "family": "bkw_span_seconds", "labels": {"name": "engine.backup"},
     "target": 120.0, "budget": 0.01,
     "description": "p99 end-to-end backup wall seconds"},
    {"id": "restore_p99", "kind": "quantile",
     "family": "bkw_span_seconds", "labels": {"name": "engine.restore"},
     "target": 120.0, "budget": 0.01,
     "description": "p99 end-to-end restore wall seconds"},
    {"id": "matchmaking_p99", "kind": "quantile",
     "family": "bkw_server_request_seconds",
     "labels": {"route": "/backups/request"},
     "target": 5.0, "budget": 0.01,
     "description": "p99 matchmaking request latency at the"
                    " coordination server"},
    {"id": "backup_overlap", "kind": "gauge_below",
     "family": "bkw_backup_overlap_efficiency", "labels": {},
     "target": 0.5, "budget": 0.25,
     "description": "streaming-dataflow overlap efficiency holds above"
                    " the floor for most of the window"},
    {"id": "repl_promote_p99", "kind": "quantile",
     "family": "bkw_repl_promote_seconds", "labels": {},
     "target": 30.0, "budget": 0.05,
     "description": "p99 successor promotion seconds (epoch commit +"
                    " log-tail replay)"},
)

# --- the SLO plane's series and diagnosis (backuwup_tpu/defaults.py:226-232,
# :291-292) ---------------------------------------------------------------------
# the series recorder's sampling cadence and ring depth (obs/series.py),
# the robust-zscore anomaly flag and the points a series needs before it
# is judged; how far back the breach explainer gathers evidence and how
# many ranked causes it keeps (obs/diagnose.py)
SERIES_SAMPLE_INTERVAL_S = 10.0
SERIES_RETENTION_POINTS = 2048
SERIES_ANOMALY_Z = 3.5
SERIES_ANOMALY_MIN_POINTS = 6
DIAGNOSE_WINDOW_S = 600.0
DIAGNOSE_TOP_CAUSES = 5

# --- durability invariant monitor (backuwup_tpu/defaults.py:297, :301) ------
DURABILITY_SWEEP_INTERVAL_S = 5.0
DURABILITY_AUDIT_MAX_AGE_S = 4 * AUDIT_INTERVAL_S

# --- holder-side reclaim (backuwup_tpu/defaults.py:326-330) -----------------
RECLAIM_MIN_INTERVAL_S = 5.0
RECLAIM_MAX_ITEMS = 4096

# --- scale-out coordination plane (backuwup_tpu/defaults.py:339, :343) -------
# in-memory matchmaking shards keyed by pubkey, and the write-behind store's
# cap on operations drained into one group commit
MATCHMAKING_SHARDS = 8
SERVER_STORE_MAX_BATCH = 256

# --- federated coordination plane (backuwup_tpu/defaults.py:351-374) ---------
FEDERATION_RING_VNODES = 64  # virtual nodes per node on the hash ring
SERVER_STORE_PARTITIONS = 4  # store partitions when the caller pins none
FEDERATION_RPC_TIMEOUT_S = 2.0
FEDERATION_PEER_BACKOFF_S = 3.0
FEDERATION_CLIENT_PIN_S = 10.0
FEDERATION_STEAL_COOLDOWN_S = 0.05

# --- replicated coordination metadata (backuwup_tpu/defaults.py:383-408) -----
# ring successors a partition's operation log ships to, the ship RPC's
# timeout and retry rounds, the forward deadline, and successor-side probing
REPL_SUCCESSORS = 2
REPL_SHIP_TIMEOUT_S = 2.0
REPL_SHIP_RETRIES = 2
REPL_SHIP_RETRY_BASE_S = 0.2
REPL_FORWARD_TIMEOUT_S = 10.0
REPL_PROBE_INTERVAL_S = 2.0
REPL_PROBE_FAILURES = 2

# --- server-side TTLs (backuwup_tpu/defaults.py:411-413) ---------------------
AUTH_CHALLENGE_TTL_S = 30.0
SESSION_TTL_S = 24 * 3600.0
P2P_REQUEST_TTL_S = 60.0

# --- UI cadence (backuwup_tpu/defaults.py:416-418; reference
# ws_status_message.rs:134-141, backup/mod.rs:112) ------------------------------
PROGRESS_DEBOUNCE_S = 0.1
PEERS_DEBOUNCE_S = 0.25
PROGRESS_TICKER_S = 0.4

# --- the engine's send loop, restore and GC (backuwup_tpu/defaults.py:37-38,
# :43-44, :88, :106, :143, :322) ---------------------------------------------
# pause packing past this many unsent local packfile bytes; resume once
# this much of the buffer is free again (reference defaults.rs:38,59)
PACKFILE_LOCAL_BUFFER_LIMIT = 100 * MiB
PACKFILE_RESUME_THRESHOLD = 50 * MiB
# storage request sizing: estimate - fulfilled, clamped to [step, cap]
# (decimal MB, like the reference send.rs:359-369)
STORAGE_REQUEST_STEP = 50 * 1000 * 1000
STORAGE_REQUEST_CAP = 150 * 1000 * 1000
# distinct peers the whole-packfile path fans out to per send tick
TRANSFER_MAX_PEERS = 4
# missed-wakeup backstop of the event-driven send loop
SEND_WAKEUP_BACKSTOP_S = 0.5
# a restore pull running this fraction of its adaptive deadline is hedged
# by a redundant pull of a spare shard
RESTORE_HEDGE_DEADLINE_FRACTION = 0.5
# GC re-packs a packfile whose live-byte fraction drops below this
GC_COMPACT_OCCUPANCY = 0.5
