"""Device-side executors: the plain PyTorch versions (batch_exec) and the
hand-written CUDA kernels behind their wrappers (fused_exec)."""
