"""PyTorch/CUDA port of backuwup_tpu's backup data plane.

Content-defined chunking, BLAKE3 fingerprinting and dedup classification
of backup streams on an NVIDIA H100, the packer and packfiles around
them, the Reed-Solomon stripes, audits and shard storage each sealed
packfile goes through, the network plane the stripes travel over
(coordination server, client control plane, signed P2P transport), and
the backup engine that runs them from a directory to peers and back
(``engine.Engine``: backup, send loop, audits, repair, GC, restore and
the startup recovery sweep), and the client app a user runs on top of
it (``app.ClientApp``, its dashboard in ``ui/``, ``python -m
backuwup_tpu_torch client|server``), bit-identical to the JAX package
(``backuwup_tpu``), which stays beside it as the reference.  The port
imports ``torch``, never ``jax``, and nothing of ``backuwup_tpu``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``, which
selects each kernel's plain PyTorch version.
"""
