"""Networking: coordination server, client control plane, P2P data plane.

Counterpart of ``backuwup_tpu/net/``: the same wire bytes, SQLite schema,
metric names and crash-site names, so either package's clients talk to
either package's server and nodes."""
