"""The resilient run loops: failure injection, checkpoint/restart, elastic
restore (the port of ``repro.runtime``)."""
