"""Command line of the PyTorch/CUDA port: ``python -m fishnet_tpu_torch``.

The port of the JAX package's ``run`` and ``uci`` commands
(fishnet_tpu/__main__.py), with the same flags plus ``--device``:

* ``run`` (the default command) is the fishnet client: the API actor,
  the queue actor and the worker pull loops over the ``tpu-nnue``
  engine, whose one shared SearchService evaluates on the GPU (or, with
  ``--device cpu``, on the CPU). First SIGINT drains, a second aborts;
  SIGTERM drains with a deadline.
* ``uci`` serves the batched NNUE search over UCI on stdin/stdout
  (logging goes to stderr: stdout belongs to the protocol).
"""

from __future__ import annotations

import asyncio
import signal
import sys
from pathlib import Path
from typing import List, Optional

from fishnet_tpu_torch import configure as configure_mod
from fishnet_tpu_torch.configure import ConfigError, Opt
from fishnet_tpu_torch.engine.base import EngineFactory
from fishnet_tpu_torch.sched.queue import BacklogOpt
from fishnet_tpu_torch.utils.logger import Logger
from fishnet_tpu_torch.utils.stats import StatsRecorder
from fishnet_tpu_torch.version import __version__

#: Seconds a SIGTERM drain may flush in-flight batches before the rest
#: are aborted upstream (the JAX package's default drain deadline).
DRAIN_DEADLINE_SECONDS = 25.0


def build_search_service(opt: Opt, logger: Logger, psqt_path=None):
    """The shared batched-search backend from the options (random
    weights, seed 0, when no --nnue-file is given), warmed up: the
    warm-up builds the CUDA kernel and initialises the device libraries,
    so the first job's time budget does not pay for them. ``psqt_path``
    requests a rung of the eval-path ladder (resilience/supervisor.py);
    None = the device's own."""
    from fishnet_tpu_torch.device import resolve_device
    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.search.service import SearchService

    device = resolve_device(opt.resolved_device())  # no GPU: fail first
    if opt.nnue_file:
        weights = NnueWeights.load(opt.nnue_file)
    else:
        logger.warn("No --nnue-file given; using random NNUE weights (dev mode).")
        weights = NnueWeights.random(seed=0)
    depth = opt.resolved_pipeline()
    logger.info(f"Pipelining {depth} eval batches on {device}.")
    service = SearchService(
        weights=weights,
        net_path=opt.nnue_file,  # the native pool reads the original file
        batch_capacity=opt.resolved_microbatch(),
        pipeline_depth=depth,
        driver_threads=opt.resolved_search_threads(),
        psqt_path=psqt_path,
        device=device,
    )
    try:
        service.warmup()
    except BaseException:
        service.close()
        raise
    return service


def build_engine_factory(opt: Opt, logger: Logger) -> EngineFactory:
    """Select the backend behind the engine seam."""
    engine = opt.resolved_engine()
    if engine == "tpu-nnue":
        from fishnet_tpu_torch.device import resolve_device
        from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
        from fishnet_tpu_torch.resilience.supervisor import (
            ServiceSupervisor,
            ladder_for,
        )

        # Fail fast on a missing GPU: the service itself builds lazily.
        device = resolve_device(opt.resolved_device())
        # The supervisor owns respawns: every rebuild of a dead service
        # goes through its bounded respawn budget and — after repeated
        # rapid deaths — steps the eval path down the device's ladder
        # (cuda: fused -> host-material, both on the hand kernel).
        supervisor = ServiceSupervisor(
            lambda rung: build_search_service(opt, logger, psqt_path=rung),
            rungs=ladder_for(device.type),
            logger=logger,
        )
        factory = TpuNnueEngineFactory(service_builder=supervisor.build)
        factory.supervisor = supervisor
        return factory
    if engine == "mock":
        from fishnet_tpu_torch.engine.mock import MockEngineFactory

        return MockEngineFactory()
    raise ConfigError(f"unknown engine backend: {engine!r}")


def _run_counts(factory: EngineFactory) -> tuple:
    """(the shared service's dispatched steps and device dispatches, the
    kernel's packed and dense launches); 0 steps without a service."""
    from fishnet_tpu_torch.ops import ft_gather

    service = getattr(factory, "service", None)
    counters = service.counters() if service is not None else {}
    return (counters.get("eval_steps", 0), counters.get("dispatches", 0),
            ft_gather.ft_accumulate_packed_cuda.launches,
            ft_gather.ft_accumulate_cuda.launches)


def _teardown_counters(factory: EngineFactory, since: tuple) -> str:
    """The shared service's counters, and its steps, its device
    dispatches (a fused dispatch counts once for its groups) and the
    kernel's launches since ``since`` (the counts after the warm-up),
    for the teardown log at -v."""
    service = getattr(factory, "service", None)
    counters = service.counters() if service is not None else {}
    supervisor = getattr(factory, "supervisor", None)
    steps, dispatches, packed, dense = (
        now - then for now, then in zip(_run_counts(factory), since))
    return (
        f"Service counters: {counters}; since warm-up: eval_steps {steps}, "
        f"dispatches {dispatches}, ft_gather launches: packed {packed}, "
        f"dense {dense}; rung "
        f"{supervisor.rung if supervisor is not None else None}"
    )


async def run_client(opt: Opt, logger: Logger) -> None:
    """The supervisor loop (main.rs:76-260)."""
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.protocol.types import EngineFlavor

    stats = StatsRecorder(
        cores=opt.resolved_cores(),
        stats_file=Path(opt.stats_file) if opt.stats_file else None,
        no_stats_file=opt.no_stats_file,
    )
    engine_factory = build_engine_factory(opt, logger)
    client = Client(
        endpoint=opt.resolved_endpoint(),
        key=opt.key,
        cores=opt.resolved_cores(),
        engine_factory=engine_factory,
        logger=logger,
        stats=stats,
        backlog=BacklogOpt(user=opt.user_backlog, system=opt.system_backlog),
        max_backoff=opt.resolved_max_backoff(),
        workers=opt.resolved_workers(),
        batch_deadline=opt.batch_deadline,
    )
    if opt.resolved_workers() != opt.resolved_cores():
        shared = opt.resolved_engine() == "tpu-nnue"
        what = ("over the shared device service" if shared
                else "(one engine instance per worker)")
        logger.info(
            f"Analyzing up to {opt.resolved_workers()} positions "
            f"concurrently {what}."
        )

    stop = asyncio.Event()
    sigints = 0
    sigterms = 0
    drain_guard: Optional[asyncio.Task] = None

    def on_sigint() -> None:
        nonlocal sigints
        sigints += 1
        if sigints == 1:
            logger.fishnet_info("Stopping soon. Press ^C again to abort pending batches ...")
            client.shutdown_soon()
        else:
            logger.fishnet_info("Stopping now.")
            stop.set()

    def on_sigterm() -> None:
        # Graceful drain: stop acquiring, flush in-flight batches until
        # the deadline, then abort the rest upstream and exit 0.
        nonlocal sigterms, drain_guard
        sigterms += 1
        if sigterms > 1:
            logger.fishnet_info("Stopping now.")
            stop.set()
            return
        logger.fishnet_info(
            f"SIGTERM: draining (flushing in-flight batches, deadline "
            f"{DRAIN_DEADLINE_SECONDS:.0f}s; send SIGTERM again to abort "
            "now) ..."
        )
        client.shutdown_soon()

        async def deadline_guard() -> None:
            await asyncio.sleep(DRAIN_DEADLINE_SECONDS)
            logger.fishnet_info(
                "Drain deadline reached; aborting remaining batches upstream."
            )
            stop.set()

        drain_guard = asyncio.create_task(deadline_guard())

    loop = asyncio.get_running_loop()
    warm = (0, 0, 0)
    try:
        loop.add_signal_handler(signal.SIGINT, on_sigint)
        loop.add_signal_handler(signal.SIGTERM, on_sigterm)
    except NotImplementedError:  # non-Unix
        pass

    try:
        # Build (and warm) the shared service before the first acquire,
        # off the event loop: the first start compiles the kernel.
        if opt.resolved_engine() == "tpu-nnue":
            await engine_factory.create(EngineFlavor.OFFICIAL)
            warm = _run_counts(engine_factory)
        logger.fishnet_info(
            f"fishnet-tpu-torch {__version__} connecting to "
            f"{opt.resolved_endpoint()}"
        )
        await client.start()
        summary = asyncio.create_task(client.run_summary_loop())
        # Exit on explicit stop (second ^C / SIGTERM deadline) OR when a
        # first-^C drain completes on its own (main.rs:248-259).
        stop_task = asyncio.create_task(stop.wait())
        drained_task = asyncio.create_task(client.wait_drained())
        try:
            await asyncio.wait({stop_task, drained_task},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in (stop_task, drained_task, summary, drain_guard):
                if t is not None:
                    t.cancel()
            await client.stop(abort_pending=stop.is_set())
    finally:
        if opt.verbose:
            logger.debug(_teardown_counters(engine_factory, warm))
        # Tear down the shared service before interpreter exit: a daemon
        # driver thread still inside native code when Python unwinds
        # takes the process down.
        engine_factory.close()
        stats.flush()
    logger.fishnet_info(client.stats_summary())


def main(argv: Optional[List[str]] = None) -> int:
    try:
        opt = configure_mod.parse_and_configure(argv)
    except ConfigError as err:
        sys.stderr.write(f"E: {err}\n")
        return 2

    if opt.resolved_command() == "uci":
        from fishnet_tpu_torch.uci_server import serve

        # stdout belongs to the UCI protocol; all logging goes to stderr.
        logger = Logger(verbose=opt.verbose, stderr=True)
        try:
            service = build_search_service(opt, logger)
        except (ValueError, RuntimeError, OSError) as err:
            sys.stderr.write(f"E: {err}\n")
            return 2
        try:
            asyncio.run(serve(service))
        except KeyboardInterrupt:
            pass
        finally:
            service.close()
        return 0

    logger = Logger(verbose=opt.verbose)
    try:
        asyncio.run(run_client(opt, logger))
    except KeyboardInterrupt:
        pass
    except (ConfigError, ValueError, RuntimeError, OSError) as err:
        # Late setup errors (no GPU, a bad --nnue-file) exit cleanly,
        # not as a traceback.
        sys.stderr.write(f"E: {err}\n")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
