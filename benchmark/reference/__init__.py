"""The benchmark's plain reference: NumPy and plain PyTorch on the host,
importing neither JAX nor anything of glia_tpu or glia_tpu_torch."""
