"""Partitioning rules: the reference's specs as DTensor placements on a
torch ``DeviceMesh`` (the port of ``repro.sharding``)."""
