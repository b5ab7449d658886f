"""Multi-device scaling: device lists, data-parallel mapping steps and the
spatially sharded grid store."""
