"""The benchmark's plain PyTorch reference: float32, no kernels, no caches,
no batching tricks. Imports nothing of the port and nothing of JAX."""

from .model import forward, plain_fp32, tta_forward

__all__ = ["forward", "plain_fp32", "tta_forward"]
