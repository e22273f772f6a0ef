"""Tunables of the port's manifest plane and dedup table.

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
