"""Version of the PyTorch/CUDA port of fishnet-tpu.

``__version__`` identifies this implementation (the UCI ``id name``
line and the User-Agent); it tracks the JAX package's version it was
ported from. ``PROTOCOL_VERSION`` is what goes in the
``fishnet.version`` request field: lichess gates clients by that
version (400/406 responses, doc/protocol.md:240-244), so the port
reports the same fishnet-compatible version as the JAX package.
"""

__version__ = "0.1.0"

PROTOCOL_VERSION = "2.6.8"


def user_agent() -> str:
    import platform

    return "fishnet-tpu-torch-{}-{}/{}".format(
        platform.system().lower(), platform.machine(), __version__
    )
