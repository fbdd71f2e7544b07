"""Version of the PyTorch/CUDA port of fishnet-tpu.

``__version__`` identifies this implementation (the UCI ``id name``
line); it tracks the JAX package's version it was ported from.
"""

__version__ = "0.1.0"
