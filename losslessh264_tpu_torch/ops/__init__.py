"""Pixel-domain ops of the torch port (plain torch + CUDA kernel wrappers)."""
