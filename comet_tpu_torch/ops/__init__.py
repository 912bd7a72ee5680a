"""Device compute: plain PyTorch ops and the hand-written CUDA kernels."""
