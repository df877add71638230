"""Companion tools: font specimen sheets, font transforms, sprite packing,
TTF conversion — the twins of the JAX package's tools, rendering with
PyTorch on a CUDA card by default (`--device cpu` for the CPU)."""
