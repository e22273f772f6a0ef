"""Snapshot layer of the port: the device dedup front."""
