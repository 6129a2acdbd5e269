"""Serving steps of the LM substrate (``serve_step``)."""
