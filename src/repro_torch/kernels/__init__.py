"""Local SDDMM / SpMM / FusedMM kernels: CUDA wrappers and plain versions."""
