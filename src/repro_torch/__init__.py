"""PyTorch + CUDA port of the PIC Monte-Carlo system in ``repro``.

Same layout as ``repro``: ``core/`` (the cycle), ``kernels/`` (hand-written
CUDA kernels for the H100 with their plain PyTorch versions, sources in
``csrc/``), ``configs/`` and ``launch/``. The package imports ``torch`` and
nothing of JAX or of ``repro``.
"""
