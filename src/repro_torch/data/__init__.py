"""The synthetic, deterministic data pipeline of LM training (the port of
``repro.data``)."""
