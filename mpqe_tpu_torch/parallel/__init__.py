"""The parallel layer: the device mesh, the edge-partitioned halo layers
and their training, and the ranking helpers (the sharded rank comes
later)."""
