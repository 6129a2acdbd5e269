"""Checkpoints: async writes, atomic manifests (the port of ``repro.ckpt``)."""
