"""fishnet-tpu ported to PyTorch and CUDA (one NVIDIA H100).

The JAX package ``fishnet_tpu`` is the reference this package is held
against bit for bit. This package imports ``torch``, ``numpy`` and the
standard library only: nothing of ``jax`` and nothing of
``fishnet_tpu`` (it keeps its own copies of what it needs).
"""

from fishnet_tpu_torch.version import __version__

__all__ = ["__version__"]
