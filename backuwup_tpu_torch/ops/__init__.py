"""Device ops of the port: CDC scan + selection, BLAKE3, the leaf-pool
digest, the manifest pipeline, the dedup table and the backends."""
