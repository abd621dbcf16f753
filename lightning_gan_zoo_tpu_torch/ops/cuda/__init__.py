"""Hand-written CUDA kernels (sources in ``csrc/``), bound with ctypes."""
