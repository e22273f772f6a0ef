"""Erasure-coded shard placement: the port's copy of
``backuwup_tpu/erasure``.

Layers:

* :mod:`.gf_cpu` — pure-numpy GF(2^8) Reed-Solomon oracle (ground truth).
* :mod:`.rs_gpu` — the batched device product (the CUDA kernel
  ``csrc/gf_matmul.cu``, K6, beside its plain PyTorch version),
  bit-exact against the oracle.
* :mod:`.stripe` — self-describing shard containers, split/assemble/
  rebuild, and the restore-side stripe assembly tree walk.

Routing between oracle and device lives on ``ops.backend.ChunkerBackend``
(``encode_shards`` / ``decode_shards``, the oracle) and ``GpuBackend``
(the device), mirroring ``digest_many``.
"""

from .stripe import (  # noqa: F401
    SHARD_ID_LEN,
    Shard,
    StripeError,
    assemble_packfile,
    assemble_tree,
    parse_shard,
    parse_shard_id,
    rebuild_shards,
    shard_id,
    split_packfile,
)
