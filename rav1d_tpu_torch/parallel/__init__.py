"""Multi-chip/multi-host scaling: meshes, tile sharding, frame pipelining."""
