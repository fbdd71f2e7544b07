"""The split evaluator plane: N search frontends, one evaluator host.

The port of ``fishnet_tpu/rpc/``. Frontends started
with ``FISHNET_RPC=1`` run their searches in their own processes and
ship each eval microbatch over a shared-memory ring
(:mod:`~fishnet_tpu_torch.rpc.rings`, the same link-file format as the
JAX package's) to one evaluator process
(:mod:`~fishnet_tpu_torch.rpc.host`), which drains every attached
frontend's ring into ONE dispatch coalescer: microbatches of different
processes fuse into one dense FT-gather launch on the GPU.

:class:`~fishnet_tpu_torch.rpc.client.RemoteBackend` IS a
``SearchService`` whose evaluator ships microbatches over the ring, so
the engines and the UCI server ride unchanged; an MctsPool given a
:class:`~fishnet_tpu_torch.rpc.client.RemoteAzPlane` sends its AZ leaf
microbatches to the same host. ``FISHNET_RPC`` unset or ``0`` keeps the
monolithic service.
"""

from fishnet_tpu_torch.rpc.rings import rpc_enabled  # noqa: F401
