"""PyTorch/CUDA port of backuwup_tpu's manifest plane and dedup table.

Content-defined chunking, BLAKE3 fingerprinting and dedup classification
of backup streams on an NVIDIA H100, bit-identical to the JAX package
(``backuwup_tpu``), which stays beside it as the reference.  The port
imports ``torch``, never ``jax``, and nothing of ``backuwup_tpu``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``, which
selects each kernel's plain PyTorch version.
"""
