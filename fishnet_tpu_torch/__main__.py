"""Command line of the PyTorch/CUDA port: ``python -m fishnet_tpu_torch``.

The port of the JAX package's commands (fishnet_tpu/__main__.py), with
the same flags plus ``--device``:

* ``run`` (the default command) is the fishnet client: the API actor,
  the queue actor and the worker pull loops over the ``tpu-nnue``
  engine, whose one shared SearchService evaluates on the GPU (or, with
  ``--device cpu``, on the CPU), or over ``--engine az-mcts``: batched
  PUCT MCTS whose policy+value net runs on the same device. First
  SIGINT drains, a second aborts; SIGTERM drains with a deadline
  (``--drain-deadline``, 25 s by default), during which the exporter's
  readiness probes (``/healthz``, ``/healthz/ready``) answer 503 with
  ``draining: true`` while ``/healthz/live`` stays 200, and
  ``fishnet_drain_state`` reads 1 (resilience/drain.py).
  ``--metrics-port`` also turns span recording on: ``/spans`` serves
  the flight recorder, SIGUSR2 dumps it as ``fishnet-spans/2`` JSONL
  into ``--spans-dir`` (else ``$FISHNET_SPANS_DIR`` or
  ``<tempdir>/fishnet-spans``), a drained exit dumps it once more, and
  ``--spans-journal`` appends every batch-trace span to a file.
  ``--tenants N`` (N > 1) runs N acquire streams through the
  multi-tenant front end (sched/frontend.py): two priority lanes, DRR
  fairness across tenants and admission control that sheds analysis
  batches past ``--lane-depth-limit`` queued positions (256 by
  default), its capacity scaled down by the supervisor's rung and an
  open submit breaker.
  ``--fault-plan`` (or ``FISHNET_FAULT_PLAN``) installs a deterministic
  fault plan before the service is built (resilience/faults.py): a
  testing aid, logged at error level.
  ``--engine uci --engine-exe EXE`` drives a UCI engine subprocess
  per worker instead (engine/uci.py); this process then builds no
  service and opens no device. ``--auto-update`` checks the release
  channel at startup and every 5 h (update.py): a staged update drains
  the client, then installs and execs again, but only after a clean
  drain with no SIGINT or SIGTERM.
* ``uci`` serves the batched NNUE search over UCI on stdin/stdout
  (logging goes to stderr: stdout belongs to the protocol).
* ``configure`` runs the configuration dialog and writes ``fishnet.ini``
  (a bare invocation without an ini file runs it too, then the client).
* ``systemd`` / ``systemd-user`` print a unit file (systemd.py).
* ``verify-net --nnue-file PATH`` checks a net against the native
  evaluator on the device (verify_net.py).
* ``license`` prints the license notice.

With ``FISHNET_RPC=1`` either command is a split-plane FRONTEND: its
searches run here and every eval microbatch rides a shared-memory ring
to the evaluator host (``python -m fishnet_tpu_torch.rpc.host``), which
holds the device; the frontend never resolves or touches one.

``--mesh`` (default ``auto``): with more than one visible GPU the
service — and the az-mcts plane — drive every card, shards placed from
the coalescer (parallel/mesh.py); with one, nothing changes. An
explicit ``DxM`` pins the shard count (``M > 1``: the legacy
``ShardedEvaluator``, one evaluator splitting every microbatch);
``off`` keeps one device.
"""

from __future__ import annotations

import asyncio
import os
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

LICENSE_NOTICE = """\
fishnet-tpu-torch is free software: you can redistribute it and/or modify it
under the terms of the GNU General Public License as published by the
Free Software Foundation, either version 3 of the License, or (at your
option) any later version. It is distributed WITHOUT ANY WARRANTY; see
https://www.gnu.org/licenses/gpl-3.0.html for the full text.
"""


def _check_key_over_network(endpoint: str, key: str) -> Optional[str]:
    """Live key validation for the config dialog (configure.rs:474-492)."""
    from fishnet_tpu_torch.net import api as api_mod

    async def check() -> Optional[str]:
        stub, actor = api_mod.channel(endpoint, key, Logger())
        task = asyncio.ensure_future(actor.run())
        try:
            err = await asyncio.wait_for(stub.check_key(), timeout=15.0)
            return None if err is None else str(err)
        except asyncio.TimeoutError:
            return None  # network error: accept, like the reference retry path
        finally:
            actor.stop()
            task.cancel()

    try:
        return asyncio.run(check())
    except Exception as err:  # server unreachable: don't block configuration
        sys.stderr.write(f"W: Could not verify key: {err}\n")
        return None


def _visible_devices(opt: Opt) -> int:
    """The devices a mesh could span: the visible GPUs, or 1 with
    ``--device cpu``."""
    if opt.resolved_device() == "cpu":
        return 1
    import torch

    return torch.cuda.device_count()


def validate_mesh(opt: Opt) -> None:
    """Fail an explicit --mesh DxM that exceeds the visible devices now,
    with a ConfigError: the service builds lazily (inside the engine
    factory's rebuild path), where the mistake would surface as an
    endless worker-restart backoff."""
    mesh_spec = opt.resolved_mesh()
    if mesh_spec in ("auto", "off"):
        return
    data, model = (int(x) for x in mesh_spec.split("x"))
    n = _visible_devices(opt)
    if data * model > n:
        raise ConfigError(
            f"--mesh {mesh_spec} needs {data * model} devices, found {n}")


def build_sharded_evaluator(opt: Opt, weights, logger: Logger):
    """The legacy multi-device tier: one ShardedEvaluator splitting
    every eval microbatch over the mesh. Only for an explicit --mesh DxM
    with M > 1, which per-shard placement cannot express; "auto", "off"
    and data-only meshes return None (the service places those shards
    from its coalescer)."""
    mesh_spec = opt.resolved_mesh()
    if mesh_spec in ("off", "auto"):
        return None
    validate_mesh(opt)
    data, model = (int(x) for x in mesh_spec.split("x"))
    if model <= 1:
        return None
    from fishnet_tpu_torch.nnue.torch_eval import params_from_weights
    from fishnet_tpu_torch.parallel.mesh import ShardedEvaluator, make_mesh

    import torch

    devs = [torch.device(opt.resolved_device(), i)
            for i in range(data * model)]
    mesh = make_mesh(devs, data=data, model=model)
    logger.info(
        f"Sharding eval batches over a {data}x{model} device mesh "
        "(one evaluator per microbatch).")
    return ShardedEvaluator(
        params_from_weights(weights, devs[0]), mesh=mesh,
        batch_capacity=opt.resolved_microbatch())


def resolve_mesh_devices(opt: Opt, evaluator, logger: Logger):
    """The serving mesh request for SearchService and the AZ plane:
    "auto" follows the visible devices (None with fewer than two), an
    explicit data-only DxM pins the shard count, and --mesh off or a
    legacy sharded evaluator stay on one device. The service itself
    falls back to one device when fewer than two remain
    (FISHNET_NO_MESH=1)."""
    mesh_spec = opt.resolved_mesh()
    if evaluator is not None or mesh_spec == "off":
        return None
    if mesh_spec == "auto":
        n = _visible_devices(opt)
        if n < 2:
            return None
        logger.info(f"Serving mesh over {n} devices (per-shard dispatch "
                    "from the coalescer).")
        return "auto"
    validate_mesh(opt)
    data, model = (int(x) for x in mesh_spec.split("x"))
    n = data * model
    if n < 2:
        return None
    logger.info(f"Serving mesh over {n} devices (per-shard dispatch "
                "from the coalescer).")
    return n


def build_search_service(opt: Opt, logger: Logger, psqt_path=None):
    """The shared batched-search backend from the options (random
    weights, seed 0, when no --nnue-file is given), warmed up: the
    warm-up builds the CUDA kernel and initialises the device libraries,
    so the first job's time budget does not pay for them. ``psqt_path``
    requests a rung of the eval-path ladder (resilience/supervisor.py);
    None = the device's own."""
    from fishnet_tpu_torch.device import resolve_device
    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.rpc import rpc_enabled
    from fishnet_tpu_torch.search.service import SearchService

    # Split plane (FISHNET_RPC=1): this process is a FRONTEND. No device,
    # no dispatch probe: every eval microbatch rides the shared-memory
    # ring to the evaluator host. Unset/0 builds the monolith below.
    rpc = rpc_enabled()
    device = None if rpc else resolve_device(opt.resolved_device())
    if opt.nnue_file:
        weights = NnueWeights.load(opt.nnue_file)
    else:
        logger.warn("No --nnue-file given; using random NNUE weights (dev mode).")
        weights = NnueWeights.random(seed=0)
    if rpc:
        from fishnet_tpu_torch.rpc.client import RemoteBackend

        logger.info(
            "FISHNET_RPC=1: frontend role; eval traffic rides the "
            "shared-memory ring transport to the evaluator host.")
        service = RemoteBackend(
            weights=weights,
            net_path=opt.nnue_file,
            batch_capacity=opt.resolved_microbatch(),
            pipeline_depth=opt.pipeline or 2,
            driver_threads=opt.resolved_search_threads(),
            psqt_path=psqt_path,
        )
    else:
        evaluator = build_sharded_evaluator(opt, weights, logger)
        mesh_devices = resolve_mesh_devices(opt, evaluator, logger)
        depth = opt.resolved_pipeline()
        logger.info(f"Pipelining {depth} eval batches on {device}.")
        service = SearchService(
            weights=weights,
            net_path=opt.nnue_file,  # the native pool reads the original file
            batch_capacity=opt.resolved_microbatch(),
            pipeline_depth=depth,
            driver_threads=opt.resolved_search_threads(),
            psqt_path=psqt_path,
            device=None if evaluator is not None else device,
            evaluator=evaluator,
            mesh_devices=mesh_devices,
        )
    try:
        service.warmup()
    except BaseException:
        service.close()
        raise
    return service


def build_engine_factory(opt: Opt, logger: Logger,
                         az_net=None) -> EngineFactory:
    """Select the backend behind the engine seam (``az_net``: the AZ net
    :func:`load_az_net` already loaded, for ``az-mcts``)."""
    engine = opt.resolved_engine()
    if engine == "tpu-nnue":
        from fishnet_tpu_torch.device import resolve_device
        from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
        from fishnet_tpu_torch.resilience.supervisor import (
            ServiceSupervisor,
            ladder_for,
        )

        from fishnet_tpu_torch.rpc import rpc_enabled

        # Fail fast on a missing GPU or a mesh larger than the host: the
        # service itself builds lazily. A split-plane frontend holds no
        # device: its one rung is the host-material wire the evaluator
        # host serves.
        if rpc_enabled():
            rungs = ("host-material",)
        else:
            rungs = ladder_for(resolve_device(opt.resolved_device()).type)
            validate_mesh(opt)
        # The supervisor owns respawns: every rebuild of a dead service
        # goes through its bounded respawn budget and — after repeated
        # rapid deaths — steps the eval path down the device's ladder
        # (cuda: fused -> host-material, both on the hand kernel).
        supervisor = ServiceSupervisor(
            lambda rung: build_search_service(opt, logger, psqt_path=rung),
            rungs=rungs,
            logger=logger,
        )
        factory = TpuNnueEngineFactory(service_builder=supervisor.build)
        factory.supervisor = supervisor
        return factory
    if engine == "az-mcts":
        return build_az_factory(opt, logger, az_net)
    if engine == "uci":
        from fishnet_tpu_torch.engine.uci import UciEngineFactory

        if not opt.engine_exe:
            raise ConfigError("--engine uci requires --engine-exe")
        return UciEngineFactory(opt.engine_exe, logger=logger)
    if engine == "mock":
        from fishnet_tpu_torch.engine.mock import MockEngineFactory

        return MockEngineFactory()
    raise ConfigError(f"unknown engine backend: {engine!r}")


def load_az_net(opt: Opt, logger: Logger):
    """The AZ net, loaded once for the engine and the snapshot: (params,
    AzConfig, fingerprint). From --az-net-file, its AzConfig read from
    the shapes (a missing, corrupt or non-AZ file is a ConfigError) and
    its fingerprint keying the snapshot's AZ section; else dev-mode
    random weights from the port's own seed (0), fingerprint 0, as the
    JAX CLI keys them."""
    from fishnet_tpu_torch.models.az import (
        AzConfig,
        az_config_from_params,
        init_az_params,
        load_az_params,
    )
    from fishnet_tpu_torch.search.eval_cache import az_net_fingerprint

    if opt.az_net_file:
        import zipfile

        try:
            params = load_az_params(opt.az_net_file)
            return (params, az_config_from_params(params),
                    az_net_fingerprint(params))
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as err:
            raise ConfigError(f"--az-net-file {opt.az_net_file}: {err}") from err
    logger.warn("No --az-net-file given; using random policy+value net (dev mode).")
    return init_az_params(0, AzConfig()), AzConfig(), 0


def build_az_factory(opt: Opt, logger: Logger, az_net=None) -> EngineFactory:
    """The az-mcts engine over ``az_net`` (:func:`load_az_net`'s result,
    loaded here when None): an AzMctsService on the device (its driver
    thread warms the plane up), variant work routed to the native
    alpha-beta tier on the host (the scalar backend: no device traffic),
    as the JAX package routes it."""
    from fishnet_tpu_torch.device import resolve_device
    from fishnet_tpu_torch.engine.az_engine import (
        AzMctsEngineFactory,
        AzMctsService,
    )
    from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.search.mcts import MctsConfig
    from fishnet_tpu_torch.search.service import SearchService

    device = resolve_device(opt.resolved_device())
    params, az_cfg, _fp = az_net or load_az_net(opt, logger)
    cfg = MctsConfig(batch_capacity=opt.resolved_microbatch(), az=az_cfg)
    logger.info(f"az-mcts: {az_cfg} on {device}, microbatch "
                f"{cfg.batch_capacity}.")
    service = AzMctsService(params, cfg, device=device,
                            devices=resolve_mesh_devices(opt, None, logger))
    try:
        fallback = SearchService(
            weights=NnueWeights.random(seed=0), backend="scalar",
            pool_slots=64, batch_capacity=64,
        )
    except BaseException:
        service.close()
        raise
    return AzMctsEngineFactory(
        service, variant_fallback=TpuNnueEngineFactory(fallback))


def _run_counts(factory: EngineFactory) -> tuple:
    """(the shared service's dispatched steps and device dispatches, the
    kernel's packed and dense launches); 0 steps without a service."""
    from fishnet_tpu_torch.ops import ft_gather

    service = getattr(factory, "service", None)
    counters = (service.counters()
                if hasattr(service, "counters") else {})
    return (counters.get("eval_steps", 0), counters.get("dispatches", 0),
            ft_gather.ft_accumulate_packed_cuda.launches,
            ft_gather.ft_accumulate_cuda.launches)


def _teardown_counters(factory: EngineFactory, since: tuple) -> str:
    """The shared service's counters, and its steps, its device
    dispatches (a fused dispatch counts once for its groups) and the
    kernel's launches since ``since`` (the counts after the warm-up),
    for the teardown log at -v."""
    service = getattr(factory, "service", None)
    if hasattr(service, "pool_counters"):
        return f"az-mcts pool counters: {service.pool_counters()}"
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
    from fishnet_tpu_torch.resilience import drain
    from fishnet_tpu_torch.search import eval_cache

    stats = StatsRecorder(
        cores=opt.resolved_cores(),
        stats_file=Path(opt.stats_file) if opt.stats_file else None,
        no_stats_file=opt.no_stats_file,
    )
    # --spans-dir / SpansDir steers where the flight recorder dumps its
    # fishnet-spans-<pid>.jsonl (spans.default_path reads the env var;
    # exporting it keeps child processes consistent with this one).
    if opt.spans_dir is not None:
        os.environ["FISHNET_SPANS_DIR"] = opt.spans_dir
    exporter = start_metrics(opt, stats, logger)
    if opt.spans_journal is not None:
        # Batch-span write-ahead: spans recorded between the last scrape
        # and a SIGKILL survive on disk.
        from fishnet_tpu_torch.telemetry.spans import RECORDER

        RECORDER.journal_to(opt.spans_journal)
    # Deterministic fault injection (--fault-plan / FISHNET_FAULT_PLAN):
    # a testing aid — loudly flagged, never silently active. Installed
    # before the service is built, so its warm-up is under the plan too.
    plan_spec = opt.resolved_fault_plan()
    if plan_spec:
        from fishnet_tpu_torch.resilience import faults

        faults.install(plan_spec)
        logger.error(
            f"FAULT INJECTION ACTIVE ({plan_spec!r}). "
            "Never run this against production traffic."
        )
    # Warm-restart snapshot (FISHNET_EVAL_CACHE_SNAPSHOT): reload the
    # previous process's eval caches, keyed by the net file's
    # fingerprint (0 for dev-mode random weights) and the AZ net's, so
    # the first batches resolve before the wire; an NNUE mismatch
    # discards the file, an AZ mismatch skips the AZ section.
    net_fp = eval_cache.net_fingerprint(opt.nnue_file) if opt.nnue_file else 0
    # The AZ net loads once, here: its fingerprint keys the snapshot's
    # AZ section (0 in dev mode, and for engines that run no AZ net).
    az_net = (load_az_net(opt, logger)
              if opt.resolved_engine() == "az-mcts" else None)
    az_fp = az_net[2] if az_net is not None else 0
    if eval_cache.snapshot_path() is not None and eval_cache.load_snapshot(
            fingerprint=net_fp, az_fingerprint=az_fp):
        cache = eval_cache.get_cache()
        az_cache = eval_cache.get_az_cache()
        logger.info(f"Restored {len(cache) if cache is not None else 0} "
                    "eval-cache entries from snapshot.")
        if az_cache is not None and len(az_cache):
            logger.info(f"Restored {len(az_cache)} AZ eval-cache entries "
                        "from snapshot.")
    engine_factory = build_engine_factory(opt, logger, az_net)
    supervisor = getattr(engine_factory, "supervisor", None)
    shed_policy = None
    if opt.lane_depth_limit is not None:
        from fishnet_tpu_torch.resilience.shedding import ShedPolicy
        from fishnet_tpu_torch.resilience.supervisor import any_breaker_open

        shed_policy = ShedPolicy(
            high_watermark=opt.lane_depth_limit,
            breaker_open_fn=any_breaker_open,
            rung_fn=(lambda: supervisor.rung) if supervisor is not None
            else None,
        )
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
        tenants=opt.resolved_tenants(),
        shed_policy=shed_policy,
        supervisor=supervisor,
    )
    if opt.resolved_workers() != opt.resolved_cores():
        shared = opt.resolved_engine() in ("tpu-nnue", "az-mcts")
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
            drain.begin("sigint", depth_fn=client.queue_depth)
            client.shutdown_soon()
        else:
            logger.fishnet_info("Stopping now.")
            stop.set()

    def on_sigterm() -> None:
        # Graceful drain: stop acquiring, flush in-flight batches until
        # the deadline, then abort the rest upstream (accounted — the
        # server reassigns) and exit 0. Readiness (/healthz,
        # /healthz/ready) flips to 503 so an orchestrator stops routing
        # at this process; liveness (/healthz/live) stays 200 —
        # draining is not wedged.
        nonlocal sigterms, drain_guard
        sigterms += 1
        if sigterms > 1:
            logger.fishnet_info("Stopping now.")
            stop.set()
            return
        deadline = opt.resolved_drain_deadline()
        logger.fishnet_info(
            f"SIGTERM: draining (flushing in-flight batches, deadline "
            f"{deadline:.0f}s; send SIGTERM again to abort now) ..."
        )
        drain.begin("sigterm", deadline=deadline, depth_fn=client.queue_depth)
        client.shutdown_soon()

        async def deadline_guard() -> None:
            await asyncio.sleep(deadline)
            logger.fishnet_info(
                "Drain deadline reached; aborting remaining batches upstream."
            )
            stop.set()

        drain_guard = asyncio.create_task(deadline_guard())

    # Periodic auto-update (main.rs:179-199): every 5 h re-check the
    # release channel; a staged update drains work (shutdown_soon ->
    # wait_drained ends the wait below) and the install and restart
    # happen after teardown, the reference's drain-then-exec.
    restart_to = None  # the UpdateStatus of a staged, deferred install

    async def update_loop() -> None:
        nonlocal restart_to
        from fishnet_tpu_torch.update import (
            UPDATE_INTERVAL_SECONDS,
            apply_update,
        )

        while True:
            await asyncio.sleep(UPDATE_INTERVAL_SECONDS)
            try:
                status = await apply_update(
                    logger=logger, allow_default=True, defer_promote=True
                )
            except Exception as err:  # noqa: BLE001 - keep serving on failures
                logger.error(f"Periodic update check failed: {err}")
                continue
            if status.updated:
                logger.fishnet_info(
                    f"Update {status.latest} staged; draining before restart ..."
                )
                restart_to = status
                client.shutdown_soon()
                return

    loop = asyncio.get_running_loop()
    warm = (0, 0, 0, 0)
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
        updater = (asyncio.create_task(update_loop())
                   if opt.auto_update else None)
        # Exit on explicit stop (second ^C / SIGTERM deadline) OR when a
        # first-^C drain completes on its own (main.rs:248-259).
        stop_task = asyncio.create_task(stop.wait())
        drained_task = asyncio.create_task(client.wait_drained())
        try:
            await asyncio.wait({stop_task, drained_task},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in (stop_task, drained_task, summary, updater,
                      drain_guard):
                if t is not None:
                    t.cancel()
            await client.stop(abort_pending=stop.is_set())
            # Persist the eval cache for a warm restart (a no-op unless
            # FISHNET_EVAL_CACHE_SNAPSHOT is set): after client.stop,
            # so it holds the final working set; before the engine
            # closes.
            if eval_cache.snapshot_path() is not None:
                eval_cache.save_snapshot(fingerprint=net_fp,
                                         az_fingerprint=az_fp)
    finally:
        # Tear down the shared service before interpreter exit: a daemon
        # driver thread still inside native code when Python unwinds
        # takes the process down.
        engine_factory.close()
        if opt.verbose:
            # After close: an aborting stop leaves the cancelled searches
            # in the service until its drivers harvest them, and they may
            # still dispatch; once it is closed the counts are final.
            logger.debug(_teardown_counters(engine_factory, warm))
            # With --engine uci the engine children own the device: this
            # process must never have opened a CUDA context.
            import torch

            logger.debug(f"cuda_context {torch.cuda.is_initialized()}")
        # Flush the (interval-debounced) stats file and stop serving
        # scrapes before teardown completes.
        stats.flush()
        if drain.draining():
            from fishnet_tpu_torch import telemetry

            if telemetry.enabled():
                telemetry.RECORDER.dump(reason="drain")
        if exporter is not None:
            exporter.close()
    logger.fishnet_info(client.stats_summary())
    # Install and restart only on a clean drain with no operator stop
    # intent: a SIGTERM or a ^C must actually stop. After teardown, so
    # no live engine has files swapped under it (update.promote_staged).
    if (restart_to is not None and not stop.is_set() and sigints == 0
            and sigterms == 0):
        from fishnet_tpu_torch.update import (
            default_install_root,
            promote_staged,
            restart_process,
        )

        ok = True
        if restart_to.staged is not None:
            try:
                promote_staged(restart_to.staged, default_install_root())
            except Exception as err:  # noqa: BLE001
                logger.error(f"Update promotion failed: {err}")
                ok = False
        elif restart_to.command:
            # An async subprocess: run_client is still on the event loop.
            proc = await asyncio.create_subprocess_exec(*restart_to.command)
            rc = await proc.wait()
            if rc != 0:
                logger.error(f"Update command failed with exit code {rc}.")
                ok = False
        if ok:
            restart_process(logger, restart_to.latest)


def start_metrics(opt: Opt, stats: StatsRecorder, logger: Logger):
    """Live telemetry, opt-in through ``--metrics-port`` (or the
    ``MetricsPort`` ini key): ``/metrics``, ``/json`` and ``/spans`` on an
    ``http.server`` thread, span recording on in the pipeline's hot
    paths, SIGUSR2 armed to dump the flight recorder, and the stats
    recorder's collector registered.
    The port file (``--metrics-port-file``) is written after bind, by
    an atomic rename, so a reader never sees a half-written number.
    Returns the exporter, or None."""
    if opt.metrics_port is None:
        return None
    from fishnet_tpu_torch import telemetry
    from fishnet_tpu_torch.utils.stats import register_stats_collector

    exporter = telemetry.start_exporter(opt.metrics_port)
    register_stats_collector(stats)
    logger.info(
        f"Serving telemetry on http://127.0.0.1:{exporter.port}/metrics "
        "(SIGUSR2 dumps the span flight recorder)."
    )
    if opt.metrics_port_file is not None:
        tmp = f"{opt.metrics_port_file}.tmp"
        with open(tmp, "w", encoding="utf-8") as fp:
            fp.write(f"{exporter.port}\n")
        os.replace(tmp, opt.metrics_port_file)
    return exporter


def main(argv: Optional[List[str]] = None) -> int:
    try:
        opt = configure_mod.parse_and_configure(
            argv, key_check=_check_key_over_network)
    except ConfigError as err:
        sys.stderr.write(f"E: {err}\n")
        return 2

    # Under the unit commands stdout carries the unit: log to stderr.
    logger = Logger(verbose=opt.verbose, stderr=opt.is_systemd())
    if opt.command == "license":
        print(LICENSE_NOTICE)
        return 0
    if opt.is_systemd():
        from fishnet_tpu_torch import systemd as systemd_mod

        if opt.command == "systemd":
            systemd_mod.systemd_system(opt)
        else:
            systemd_mod.systemd_user(opt)
        return 0
    if opt.command == "configure":
        return 0  # the dialog ran inside parse_and_configure
    if opt.command == "verify-net":
        if not opt.nnue_file:
            sys.stderr.write("E: verify-net requires --nnue-file PATH\n")
            return 2
        from fishnet_tpu_torch.verify_net import run_cli

        try:
            return run_cli(str(opt.nnue_file), device=opt.resolved_device(),
                           verbose=opt.verbose)
        except (ValueError, RuntimeError) as err:  # no GPU, a bad --device
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
        logger.debug(f"UCI service warmed up on "
                     f"{getattr(service, 'device', None)}, rung "
                     f"{service.psqt_path}")
        try:
            asyncio.run(serve(service))
        except KeyboardInterrupt:
            pass
        finally:
            service.close()
        return 0

    if opt.auto_update:
        from fishnet_tpu_torch.update import auto_update

        auto_update(logger)
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
