"""The peak the benchmark's roofline shares are taken against: one NVIDIA
H100 SXM's HBM3 bandwidth (NVIDIA's data sheet, at the full 700 W power
limit). The PIC step and its kernels are bound by bytes."""

HBM_BYTES_PER_S = 3.35e12
