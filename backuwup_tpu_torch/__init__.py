"""PyTorch/CUDA port of backuwup_tpu's backup data plane.

Content-defined chunking, BLAKE3 fingerprinting and dedup classification
of backup streams on an NVIDIA H100, the packer and packfiles around
them, and the Reed-Solomon stripes, audits and shard storage each sealed
packfile goes through, bit-identical to the JAX package
(``backuwup_tpu``), which stays beside it as the reference.  The port
imports ``torch``, never ``jax``, and nothing of ``backuwup_tpu``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``, which
selects each kernel's plain PyTorch version.
"""
