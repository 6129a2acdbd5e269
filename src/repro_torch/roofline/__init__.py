"""Roofline terms counted as the program runs, and their table (the port
of ``repro.roofline``; the reference's HLO parser has no counterpart)."""
