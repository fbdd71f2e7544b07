"""Evaluator host: one device-holding process serving N frontends.

The port of ``fishnet_tpu/rpc/host.py``. The host's sweep drains every
attached frontend's submit ring and stages each record as a ticket on
ONE process-local ``_DispatchCoalescer`` per search family, the
machinery a monolith uses to fuse its pipeline groups, so microbatches
from DIFFERENT PROCESSES fuse into one dispatch. NNUE: on the GPU, ONE
launch of the hand FT-gather kernel in its dense mode with in-batch
parents (``evaluate_batch`` with ``parent=`` and the host material
term), then the int8 head. AZ: the fused leaf rows of every frontend's
MCTS pools through ``models/az.py:wire_forward``, the forward the
in-process ``AzDispatchPlane`` runs. The sweep thread is the host's
only driver and has the process's interpreter lock to itself.

Parity: NNUE records carry the exact padded dense arrays of the
frontend's external-evaluator seam, evaluated through the same integer
arithmetic; each entry's value does not depend on its batch, so concat
and pad leave it bit-identical. AZ records carry the exact uint8 plane
wire and are answered with the same fp16 logits wire. Their forward
shapes are the in-process plane's ladder (``az_plane._bucket_ladder``:
powers of two from 32 on the CPU, from 256 on CUDA, up to
``--az-capacity``), and a fused batch above the capacity is cut into
capacity-sized forwards: on the H100 cuDNN's rows agree bit for bit only
between shapes of that ladder, so a remote row equals the plane's. (The
JAX host pads to the next power of two from 32 with no upper bound; on
the CPU the rows are the same at every shape, so only the forwards'
count differs.)

Every NNUE record is checked before it is staged
(``check_nnue_record``): its length, its buckets, its feature indices,
and its parent codes, each -1 or an earlier plain full entry of the
same record (a persistent anchor code, which needs device tables this
wire does not carry, is refused). An AZ record must hold ``n`` rows of
planes. A refused record never reaches the device: the host logs why,
counts ``refused.nnue`` / ``refused.az`` and answers with an empty
result, which the frontend raises as ``EvaluatorRefusedError``. A kernel
that refuses an index anyway (its device error word grows) fails the
dispatch (``NativeCoreError``): its tickets go unanswered
(``eval_errors``) and their frontends' demand waits time out.

Failure contract: submit records carrying an epoch older than the
link's current frontend epoch are refused (a restarted frontend's
predecessor is never double-served); a frontend past the lease without
a heartbeat has its link detached and unlinked, staged work dropped;
every (re)attach bumps the host epoch, so frontends resubmit what a
dead host consumed without answering. An injected ``rpc.detach`` fault
(resilience/faults.py grammar; the plan comes from
``FISHNET_FAULT_PLAN``) is polled once per sweep while at least one
link is attached and drops the first link mid-flight without unlinking
it: the next sweep re-attaches it, and the epoch bump makes its
frontend resubmit.

Run it: ``python -m fishnet_tpu_torch.rpc.host --nnue-file w.nnue
--az-seed 0`` (``--device cuda`` by default; without a GPU that
raises). ``--az-seed`` draws the port's own numpy parameters
(``models/az.py:init_az_params``), not the JAX package's
``jax.random`` ones. ``--metrics-port`` (with ``--metrics-port-file``)
serves the host's telemetry as the client's does — ``/metrics`` with
its ``fishnet_rpc_*`` families, and ``/spans``: each backend's dispatch
records a ``dispatch_issue`` span (width, n, slots, fill), as the JAX
host's does.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.chess.core import NativeCoreError
from fishnet_tpu_torch.device import DeviceLike, resolve_device
from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.resilience import faults
from fishnet_tpu_torch.rpc import rings
from fishnet_tpu_torch.search.coalesce import (
    CoalesceBackend,
    _DispatchCoalescer,
)
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS

__all__ = ["EvaluatorHost", "check_nnue_record", "main"]

#: Bytes of one AZ submit row (uint8 planes).
_AZ_ROW_BYTES = 8 * 8 * 19


def _pad_bucket(total: int, floor: int = 32) -> int:
    """Dispatch-shape bucket: next power of two >= total (floor 32), so
    the fill accounting sees honest padded slot counts."""
    b = floor
    while b < total:
        b *= 2
    return b


def check_nnue_record(feats: np.ndarray, buckets: np.ndarray,
                      parents: np.ndarray) -> None:
    """Refuse a microbatch the dense kernel must never see, before its
    parents are rebased into a fused batch. Raises ``ValueError`` naming
    the fault: a bucket outside the head's layer stacks, a feature index
    past the removal range, or a parent code other than -1 (a plain
    full) and an in-batch delta on an EARLIER plain full of the same
    record (code = index << 1 | perspective swap)."""
    n = len(buckets)
    if n == 0:
        raise ValueError("empty microbatch")
    if ((buckets < 0) | (buckets >= spec.NUM_PSQT_BUCKETS)).any():
        raise ValueError(
            f"bucket outside 0..{spec.NUM_PSQT_BUCKETS - 1}: "
            f"{int(buckets.min())}..{int(buckets.max())}")
    if int(feats.max()) > spec.DELTA_BASE + spec.NUM_FEATURES:
        raise ValueError(f"feature index {int(feats.max())} past the "
                         f"removal range ({spec.DELTA_BASE} + "
                         f"{spec.NUM_FEATURES})")
    p = parents.astype(np.int64)
    if (p <= -2).any():
        raise ValueError(
            "persistent anchor code on the dense wire (it carries no "
            "anchor tables)")
    delta = np.flatnonzero(p >= 0)
    ref = p[delta] >> 1
    if (ref >= delta).any():
        raise ValueError("in-batch parent does not point at an earlier "
                         "entry of its record")
    if (p[ref] != -1).any():
        raise ValueError("in-batch parent points at a delta entry")


class _HostNnueBackend(CoalesceBackend):
    """Minimal CoalesceBackend over ``torch_eval.evaluate_batch``: one
    device, no async pipeline; the sweep thread is the only driver, so
    pinned-width parking plus demand-side flushing is the whole
    scheduler. ``_run`` is synchronous, as in the JAX package.

    Each dispatch makes one upload from a pinned int32 staging buffer
    (features, buckets, parents, material), one launch of the kernel's
    dense mode and one read-back of the values and the kernel's error
    word; a grown error word raises."""

    driver_threads = 1

    def __init__(self, params, device: torch.device) -> None:
        self._params = params
        self.device = device
        self._staged: Dict[int, Tuple] = {}
        self._async_pipes: List = []
        self._coalescer = _DispatchCoalescer(
            self, pinned_width=_DispatchCoalescer.MAX_WIDTH
        )
        self._gpu = device.type == "cuda"
        self._in_t: Optional[torch.Tensor] = None
        self._out_t: Optional[torch.Tensor] = None
        self._err_t = (torch.zeros(1, dtype=torch.int32, pin_memory=True)
                       if self._gpu else None)
        self._err_base = 0
        # Dispatch accounting (the sweep thread's own): dispatches, fused
        # ones (more than one record), records, real rows, padded slots,
        # and the wall seconds of _run.
        self.dispatches = 0
        self.fused_dispatches = 0
        self.segments = 0
        self.rows = 0
        self.slots = 0
        self.run_s = 0.0

    def warmup(self) -> None:
        """One all-padding dispatch: builds the CUDA kernel and
        initialises the device libraries before the first frontend's
        demand, then takes the error word's baseline."""
        self._evaluate(self._stage_inputs(32, []))
        if self._gpu:
            from fishnet_tpu_torch.ops.ft_gather import kernel_errors

            self._err_base = kernel_errors(self.device)

    def stage(self, group: int, feats, buckets, parents, material) -> None:
        self._staged[group] = (feats, buckets, parents, material)

    def _staging(self, bucket: int) -> np.ndarray:
        """The pinned int32 input buffer (grown to ``bucket`` entries):
        features [B, 2, 32], then buckets, parents, material [B]."""
        need = bucket * (2 * spec.MAX_ACTIVE_FEATURES + 3)
        if self._in_t is None or self._in_t.numel() < need:
            self._in_t = torch.empty(need, dtype=torch.int32,
                                     pin_memory=self._gpu)
            self._out_t = torch.empty(bucket, dtype=torch.int32,
                                      pin_memory=self._gpu)
        return self._in_t.numpy()[:need]

    def _stage_inputs(self, bucket: int, segs: List[Tuple]) -> int:
        """Write ``segs`` (checked records) into the staging buffer, padded
        to ``bucket`` entries with plain all-sentinel fulls, each
        segment's in-batch parent codes rebased by its offset in the
        fused batch. Returns ``bucket``."""
        buf = self._staging(bucket)
        nf = bucket * 2 * spec.MAX_ACTIVE_FEATURES
        feats = buf[:nf].reshape(bucket, 2, spec.MAX_ACTIVE_FEATURES)
        buckets = buf[nf: nf + bucket]
        parents = buf[nf + bucket: nf + 2 * bucket]
        material = buf[nf + 2 * bucket: nf + 3 * bucket]
        off = 0
        for f, b, p, m in segs:
            k = len(b)
            feats[off: off + k] = f
            buckets[off: off + k] = b
            material[off: off + k] = m
            # Delta parent codes index BATCH ENTRIES (code >> 1, low bit
            # = perspective swap): rebase each segment's references by
            # its entry offset in the fused batch.
            parents[off: off + k] = np.where(p >= 0, p + (off << 1), p)
            off += k
        feats[off:] = spec.NUM_FEATURES
        buckets[off:] = 0
        parents[off:] = -1
        material[off:] = 0
        return bucket

    def _evaluate(self, bucket: int) -> np.ndarray:
        """Evaluate the staged ``bucket`` entries on the device: one
        upload, ``evaluate_batch`` (one dense kernel launch on the GPU),
        one read-back. Raises ``NativeCoreError`` when the kernel refused
        an index or a reference meanwhile."""
        from fishnet_tpu_torch.nnue.torch_eval import evaluate_batch

        dev = self.device
        need = bucket * (2 * spec.MAX_ACTIVE_FEATURES + 3)
        x = self._in_t[:need].to(dev, non_blocking=True)
        nf = bucket * 2 * spec.MAX_ACTIVE_FEATURES
        values = evaluate_batch(
            self._params,
            x[:nf].view(bucket, 2, spec.MAX_ACTIVE_FEATURES),
            x[nf: nf + bucket], x[nf + bucket: nf + 2 * bucket],
            x[nf + 2 * bucket: nf + 3 * bucket],
        )
        out = self._out_t[:bucket]
        if not self._gpu:
            out.copy_(values)
            return np.array(out.numpy(), dtype=np.int32)
        from fishnet_tpu_torch.ops.ft_gather import error_word

        out.copy_(values, non_blocking=True)
        self._err_t.copy_(error_word(dev), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        errors = int(self._err_t[0])
        if errors > self._err_base:
            # This dispatch fails; the next starts from the new count.
            refused, self._err_base = errors - self._err_base, errors
            raise NativeCoreError(
                f"ft_gather kernel refused {refused} out-of-range indices "
                "or malformed references")
        return np.array(out.numpy(), dtype=np.int32)

    def _run(self, segs: List[Tuple]) -> np.ndarray:
        tel = _telemetry.enabled()
        t_span = time.monotonic() if tel else 0.0
        t0 = time.perf_counter()
        total = sum(len(s[1]) for s in segs)
        bucket = _pad_bucket(total)
        values = self._evaluate(self._stage_inputs(bucket, segs))
        self.run_s += time.perf_counter() - t0
        self.dispatches += 1
        self.fused_dispatches += len(segs) > 1
        self.segments += len(segs)
        self.rows += total
        self.slots += bucket
        rings.note("fused.rows.nnue", total)
        rings.note("fused.slots.nnue", bucket)
        if bucket > total:
            rings.note("pad.rows", bucket - total)
        if tel:
            _SPANS.record(
                "dispatch_issue", t_span, width=len(segs),
                n=total, slots=bucket, fill=total / bucket,
            )
        return values

    def _dispatch_eval(self, group: int, n: int, rows: int):
        values = self._run([self._staged.pop(group)])
        return values[:n], (n, n * rings.NNUE_ENTRY_BYTES, n * 4)

    def _dispatch_segmented(self, tickets) -> None:
        segs = [self._staged.pop(tk.group) for tk in tickets]
        full = self._run(segs)
        off = 0
        for tk, seg in zip(tickets, segs):
            k = len(seg[1])
            tk.values = full[off: off + k]
            tk.start, tk.seg_size = 0, k
            tk.acct = (k, k * rings.NNUE_ENTRY_BYTES, k * 4)
            off += k


class _HostAzBackend(CoalesceBackend):
    """The AZ twin of ``_HostNnueBackend``: the in-process plane's forward
    (``wire_forward``: uint8 planes in, fp16 logits and float32 values
    out) over the concatenated leaf rows of every frontend's MCTS pools,
    at the plane's bucket ladder for ``cfg.batch_capacity`` (module
    docstring). ``params`` is the JAX-layout dict of numpy arrays
    (models/az.py). Each forward makes one upload from a pinned staging
    slot of its bucket, the tower, and one read-back into pinned fp16
    and float32 tensors."""

    driver_threads = 1

    def __init__(self, params, cfg, device: torch.device) -> None:
        from fishnet_tpu_torch.models.az import params_from_jax
        from fishnet_tpu_torch.search.az_plane import (
            CPU_MIN_BUCKET,
            CUDA_MIN_BUCKET,
            _bucket_ladder,
            configure_backends,
        )

        self.device = configure_backends(device)
        self._gpu = self.device.type == "cuda"
        self._net = params_from_jax(params, self.device)
        if self._net.cfg != cfg.az:
            raise ValueError(f"params are a {self._net.cfg}, not {cfg.az}")
        self._cap = int(cfg.batch_capacity)
        self._buckets = _bucket_ladder(
            self._cap, CUDA_MIN_BUCKET if self._gpu else CPU_MIN_BUCKET)
        self.policy_size = self._net.cfg.policy_size
        self._staged: Dict[int, np.ndarray] = {}
        self._async_pipes: List = []
        self._coalescer = _DispatchCoalescer(
            self, pinned_width=_DispatchCoalescer.MAX_WIDTH
        )
        # bucket -> (pinned planes, pinned fp16 logits, pinned values)
        self._slots: Dict[int, Tuple] = {}
        # Dispatch accounting, as the NNUE backend's, plus forwards (a
        # dispatch above the capacity runs several) and the most rows one
        # fused dispatch carried.
        self.dispatches = 0
        self.fused_dispatches = 0
        self.segments = 0
        self.rows = 0
        self.slots = 0
        self.forwards = 0
        self.max_rows = 0
        self.run_s = 0.0

    @property
    def buckets(self) -> List[int]:
        return list(self._buckets)

    def warmup(self) -> None:
        """Every bucket's forward once (cuDNN and the allocator warm up
        before the first frontend's demand)."""
        for bucket in self._buckets:
            self._forward(np.zeros((0,) + rings.AZ_PLANE_SHAPE, np.uint8),
                          bucket)

    def stage(self, group: int, planes_u8: np.ndarray) -> None:
        self._staged[group] = planes_u8

    def _slot(self, bucket: int) -> Tuple:
        slot = self._slots.get(bucket)
        if slot is None:
            pin = self._gpu
            slot = (
                torch.zeros((bucket,) + rings.AZ_PLANE_SHAPE,
                            dtype=torch.uint8, pin_memory=pin),
                torch.empty((bucket, self.policy_size), dtype=torch.float16,
                            pin_memory=pin),
                torch.empty((bucket,), dtype=torch.float32, pin_memory=pin),
            )
            self._slots[bucket] = slot
        return slot

    def _forward(self, rows: np.ndarray, bucket: int):
        """One forward of ``rows`` padded with zero planes to ``bucket``;
        returns copies of the rows' fp16 logits and float32 values."""
        from fishnet_tpu_torch.models.az import wire_forward

        k = len(rows)
        planes, logits_h, values_h = self._slot(bucket)
        buf = planes.numpy()
        buf[:k] = rows
        buf[k:] = 0
        if not self._gpu:
            logits, values = wire_forward(self._net, planes)
            return logits[:k].numpy().copy(), values[:k].numpy().copy()
        logits, values = wire_forward(
            self._net, planes.to(self.device, non_blocking=True))
        logits_h[:k].copy_(logits[:k], non_blocking=True)
        values_h[:k].copy_(values[:k], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return logits_h[:k].numpy().copy(), values_h[:k].numpy().copy()

    def _bucket_for(self, k: int) -> int:
        for b in self._buckets:
            if b >= k:
                return b
        return self._buckets[-1]

    def _run(self, segs: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        tel = _telemetry.enabled()
        t_span = time.monotonic() if tel else 0.0
        t0 = time.perf_counter()
        rows = segs[0] if len(segs) == 1 else np.concatenate(segs)
        total = len(rows)
        logits, values, slots = [], [], 0
        for off in range(0, total, self._cap):
            chunk = rows[off: off + self._cap]
            bucket = self._bucket_for(len(chunk))
            lg, v = self._forward(chunk, bucket)
            logits.append(lg)
            values.append(v)
            slots += bucket
            self.forwards += 1
        self.run_s += time.perf_counter() - t0
        self.dispatches += 1
        self.fused_dispatches += len(segs) > 1
        self.segments += len(segs)
        self.rows += total
        self.slots += slots
        self.max_rows = max(self.max_rows, total)
        rings.note("fused.rows.az", total)
        rings.note("fused.slots.az", slots)
        if slots > total:
            rings.note("pad.rows", slots - total)
        if tel:
            _SPANS.record(
                "dispatch_issue", t_span, width=len(segs),
                n=total, slots=slots, fill=total / slots,
            )
        if len(logits) == 1:
            return logits[0], values[0]
        return np.concatenate(logits), np.concatenate(values)

    def _acct(self, k: int) -> Tuple[int, int, int]:
        return (k, k * _AZ_ROW_BYTES, k * (self.policy_size * 2 + 4))

    def _dispatch_eval(self, group: int, n: int, rows: int):
        logits16, values = self._run([self._staged.pop(group)])
        return (logits16[:n], values[:n]), self._acct(n)

    def _dispatch_segmented(self, tickets) -> None:
        segs = [self._staged.pop(tk.group) for tk in tickets]
        logits16, values = self._run(segs)
        off = 0
        for tk, seg in zip(tickets, segs):
            k = len(seg)
            tk.values = (logits16[off: off + k], values[off: off + k])
            tk.start, tk.seg_size = 0, k
            tk.acct = self._acct(k)
            off += k


class EvaluatorHost:
    """Discovers link files in the rpc dir, drains their submit rings
    into the coalescer, fans results back by link. One sweep thread owns
    every host-side ring word (the single-writer contract).

    ``sweep()`` is public and synchronous so in-process tests can drive
    the host deterministically without the polling thread.
    ``nnue_params`` (``torch_eval.params_from_weights`` on ``device``)
    serves NNUE records; ``az_params`` (the JAX-layout dict of numpy
    arrays, as an ``.npz`` holds it) with ``az_cfg`` (an ``MctsConfig``:
    its ``batch_capacity`` is the ladder's top; default 256 and the
    params' own ``AzConfig``) serves AZ records. A family without params
    is unserviceable."""

    def __init__(
        self,
        nnue_params=None,
        az_params=None,
        az_cfg=None,
        rpc_dir: Optional[str] = None,
        lease_s: float = rings.LEASE_S,
        poll_s: float = 0.002,
        linger_s: Optional[float] = None,
        device: DeviceLike = None,
    ) -> None:
        self._dir = rpc_dir or rings.rpc_dir()
        self._lease_s = lease_s
        self._poll_s = poll_s
        if linger_s is None:
            linger_s = float(
                os.environ.get("FISHNET_HOST_LINGER_MS", "2")
            ) / 1000.0
        self._linger_s = max(0.0, linger_s)
        self._links: Dict[str, rings.RingLink] = {}
        self._groups = itertools.count(1)
        self._nnue = self._az = None
        self.device: Optional[torch.device] = None
        if nnue_params is not None or az_params is not None:
            self.device = resolve_device(device)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        if nnue_params is not None:
            self._nnue = _HostNnueBackend(nnue_params, self.device)
        if az_params is not None:
            if az_cfg is None:
                from fishnet_tpu_torch.models.az import az_config_from_params
                from fishnet_tpu_torch.search.mcts import MctsConfig

                az_cfg = MctsConfig(az=az_config_from_params(az_params))
            self._az = _HostAzBackend(az_params, az_cfg, self.device)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Guards _links: the sweep loop runs on its own thread while
        # close() detaches from the caller's thread.
        self._lock = threading.Lock()
        rings.set_role("evaluator")

    def warmup(self) -> None:
        """Build the kernel, run every AZ bucket's forward once and
        initialise the device before the first frontend attaches."""
        if self._nnue is not None:
            self._nnue.warmup()
        if self._az is not None:
            self._az.warmup()

    def counters(self) -> Dict[str, float]:
        """The NNUE backend's dispatch accounting: dispatches, fused
        dispatches, records, real rows, padded slots and the wall
        seconds of its dispatches; the attached links; under ``az`` the
        AZ backend's, with its forwards and the most rows one dispatch
        fused."""
        be = self._nnue
        out = {"links": len(self._links)}
        keys = ("dispatches", "fused_dispatches", "segments", "rows",
                "slots", "run_s")
        for key in keys:
            out[key] = getattr(be, key) if be is not None else 0
        if self._az is not None:
            out["az"] = {key: getattr(self._az, key)
                         for key in keys + ("forwards", "max_rows")}
        return out

    # -- link lifecycle ----------------------------------------------------

    def _scan(self) -> None:
        try:
            names = sorted(os.listdir(self._dir))
        except OSError:
            return
        fresh = []
        for name in names:
            if not name.endswith(".ring"):
                continue
            path = os.path.join(self._dir, name)
            if path in self._links:
                continue
            try:
                link = rings.attach_host_link(path)
            except (OSError, ValueError):
                continue  # foreign/torn/vanished file: skip, never serve
            with self._lock:
                self._links[path] = link
            fresh.append(link)
            rings.note("attach.host")
        if fresh:
            # Generation tick: every frontend watching one of these
            # links sees the epoch move and resubmits its in-flight
            # work; covers both a host restart and a re-attach.
            rings.bump_host_epoch(fresh)

    def _detach(self, path: str, reason: str, unlink: bool) -> None:
        with self._lock:
            link = self._links.pop(path, None)
        if link is None:
            return
        link.close()
        if unlink:
            try:
                os.unlink(path)
            except OSError:
                pass
        rings.note(f"detach.{reason}")

    # -- the sweep ---------------------------------------------------------

    def _drain(self) -> List[Tuple]:
        """Beat, reap, and drain every attached link's submit ring;
        returns the fence-filtered records. Called once per sweep plus
        once per linger re-drain tick."""
        work: List[Tuple] = []
        for path, link in list(self._links.items()):
            link.beat()
            if link.peer_age() > self._lease_s:
                self._detach(path, "lease", unlink=True)
                continue
            for kind, ticket, epoch, n, payload in link.drain():
                if epoch < link.frontend_epoch:
                    # Fenced: a record from the link's previous life.
                    rings.note("stale_refusals")
                    continue
                work.append((link, kind, ticket, epoch, n, payload))
        return work

    def _refuse(self, link: rings.RingLink, ticket: int, epoch: int,
                why: str, family: str = "nnue") -> None:
        """Answer a malformed record with an empty result (n = 0): the
        frontend raises it at once instead of waiting out its timeout."""
        rings.note(f"refused.{family}")
        sys.stderr.write(
            f"rpc host: refused {family} microbatch ticket {ticket} from "
            f"{os.path.basename(link.path)}: {why}\n")
        kind = (rings.KIND_NNUE_RESULT if family == "nnue"
                else rings.KIND_AZ_RESULT)
        try:
            link.push(kind, ticket, epoch, 0, b"", deadline_s=2.0)
        except (rings.RingFull, ValueError):
            rings.note("result_drops")

    def sweep(self) -> int:
        """One full service round: scan, fault poll, lease reap, drain,
        fuse-dispatch, fan results back. Returns records served."""
        self._scan()
        plan = faults.current()
        if plan is not None and self._links:
            rule = plan.poll("rpc.detach")
            if rule is not None:
                # Drop one live link mid-flight: records its attachment
                # consumed are gone; the re-attach epoch bump makes the
                # frontend re-pay them.
                self._detach(sorted(self._links)[0], "fault", unlink=False)
        work = self._drain()
        if not work:
            return 0
        if self._linger_s > 0.0 and len(self._links) > 1:
            # Several frontends' waves land microseconds apart: a bounded
            # linger re-drains the rings until the window closes, so
            # skewed waves bucket by their FUSED row count instead of
            # each paying its own padded bucket. With one frontend the
            # linger is pure latency with nothing to fuse.
            deadline = time.monotonic() + self._linger_s
            while True:
                now = time.monotonic()
                if now >= deadline:
                    break
                time.sleep(min(0.0005, deadline - now))
                work.extend(self._drain())
        staged = []
        for link, kind, ticket, epoch, n, payload in work:
            if kind == rings.KIND_NNUE_SUBMIT and self._nnue is not None:
                family, be = "nnue", self._nnue
                try:
                    record = rings.unpack_nnue_submit(payload, n)
                    check_nnue_record(*record[:3])
                except ValueError as err:
                    self._refuse(link, ticket, epoch, str(err))
                    continue
            elif kind == rings.KIND_AZ_SUBMIT and self._az is not None:
                family, be = "az", self._az
                try:
                    if n <= 0:
                        raise ValueError("empty microbatch")
                    record = (rings.unpack_az_submit(payload, n),)
                except ValueError as err:
                    self._refuse(link, ticket, epoch, str(err), "az")
                    continue
            else:
                rings.note("unserviceable")
                continue
            gid = next(self._groups)
            be.stage(gid, *record)
            # Submit-all-then-demand: everything drained this sweep parks
            # together, so the first demand's flush fuses the cross-
            # process batch into one dispatch per family.
            tk = be._coalescer.submit(gid, n, n)
            staged.append((link, ticket, epoch, n, family, be, tk))
        served = 0
        for link, ticket, epoch, n, family, be, tk in staged:
            try:
                values = be._coalescer.demand(tk)
            except NativeCoreError as err:
                rings.note("eval_errors")
                sys.stderr.write(f"rpc host: dispatch failed: {err}\n")
                continue  # the frontend's demand timeout requeues it
            if family == "nnue":
                rkind, out = (rings.KIND_NNUE_RESULT,
                              rings.pack_nnue_result(values))
            else:
                rkind, out = (rings.KIND_AZ_RESULT,
                              rings.pack_az_result(*values))
            try:
                link.push(rkind, ticket, epoch, n, out, deadline_s=2.0)
            except (rings.RingFull, rings.RecordTooLarge, ValueError):
                # A frontend not draining results is dying; the lease
                # will reap it, and a survivor re-pays via resubmit.
                rings.note("result_drops")
                continue
            rings.note(f"results.{family}")
            served += 1
        return served

    # -- run modes ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="rpc-evaluator", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            # The current device is per thread: the sweep's launches and
            # events go to the host's device.
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            if self.sweep() == 0:
                time.sleep(self._poll_s)

    def serve_forever(self) -> None:
        self._loop()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            links = list(self._links.values())
            self._links.clear()
        for link in links:
            link.close()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        prog="python -m fishnet_tpu_torch.rpc.host",
        description="Evaluator host for the split plane: serves the NNUE "
        "microbatches of every FISHNET_RPC=1 frontend and the AZ leaf "
        "microbatches of every RemoteAzPlane on one device.",
    )
    parser.add_argument("--dir", default=None,
                        help="link directory (default: FISHNET_RPC_DIR)")
    parser.add_argument("--nnue-file", default=None,
                        help="NNUE weights to serve alpha-beta traffic "
                        "(the frontends' net)")
    parser.add_argument("--az-seed", type=int, default=None,
                        help="serve AZ/MCTS traffic with the default "
                        "AzConfig's params from init_az_params(seed) (the "
                        "port's numpy draw)")
    parser.add_argument("--az-capacity", type=int, default=256,
                        help="AZ bucket-ladder capacity (the largest "
                        "forward)")
    parser.add_argument("--lease", type=float, default=rings.LEASE_S)
    parser.add_argument("--poll", type=float, default=0.002)
    parser.add_argument("--linger-ms", type=float, default=None,
                        help="cross-frontend fusion window (default: "
                        "FISHNET_HOST_LINGER_MS, 2 ms)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the microbatches are evaluated "
                        "(default cuda; without a GPU it refuses)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="serve /metrics, /json, /spans and /healthz "
                        "on this port (0: ephemeral); enables span "
                        "recording. Default: off")
    parser.add_argument("--metrics-port-file", default=None,
                        help="write the bound metrics port to this file "
                        "once listening")
    args = parser.parse_args(argv)
    if not args.nnue_file and args.az_seed is None:
        parser.error("nothing to serve: pass --nnue-file and/or --az-seed")
    try:
        faults.install_from_env()
    except faults.FaultPlanError as err:
        sys.stderr.write(f"E: invalid {faults.PLAN_ENV}: {err}\n")
        return 2

    from fishnet_tpu_torch.nnue.torch_eval import params_from_weights
    from fishnet_tpu_torch.nnue.weights import NnueWeights

    exporter = None
    if args.metrics_port is not None:
        exporter = _telemetry.start_exporter(args.metrics_port)
        if args.metrics_port_file is not None:
            # Written after bind, by an atomic rename: a reader never
            # sees a half-written number.
            tmp = f"{args.metrics_port_file}.tmp"
            with open(tmp, "w", encoding="utf-8") as fp:
                fp.write(f"{exporter.port}\n")
            os.replace(tmp, args.metrics_port_file)
    try:
        device = resolve_device(args.device)
        nnue_params = az_params = az_cfg = None
        if args.nnue_file:
            nnue_params = params_from_weights(
                NnueWeights.load(args.nnue_file), device)
        if args.az_seed is not None:
            from fishnet_tpu_torch.models.az import init_az_params
            from fishnet_tpu_torch.search.mcts import MctsConfig

            az_cfg = MctsConfig(batch_capacity=args.az_capacity)
            az_params = init_az_params(args.az_seed, az_cfg.az)
        host = EvaluatorHost(
            nnue_params=nnue_params, az_params=az_params, az_cfg=az_cfg,
            rpc_dir=args.dir, lease_s=args.lease, poll_s=args.poll,
            linger_s=(
                None if args.linger_ms is None else args.linger_ms / 1000.0
            ),
            device=device,
        )
    except (ValueError, RuntimeError, OSError) as err:
        sys.stderr.write(f"E: {err}\n")
        if exporter is not None:
            exporter.close()
        return 2
    # A supervisor's drain sends SIGTERM: leave the serve loop cleanly so
    # the process exits 0, like a draining frontend.
    def _graceful(_sig, _frm):
        raise KeyboardInterrupt

    previous = signal.signal(signal.SIGTERM, _graceful)
    try:
        host.warmup()
        sys.stderr.write(f"rpc host: serving {host._dir} on {device}\n")
        sys.stderr.flush()
        host.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        host.close()
        signal.signal(signal.SIGTERM, previous)
        if exporter is not None:
            exporter.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
