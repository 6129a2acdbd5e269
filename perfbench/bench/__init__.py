"""The benchmark's own library: finding files by name, the device, the
step window, the trace, the frozen byte counts and the comparison that
decides ``correct``. Imports nothing of the program at import time."""
