"""``python -m fishnet_tpu_torch verify-net``: prove a real .nnue asset
is compatible.

The port's copy of ``fishnet_tpu/verify_net.py``: the same stages, the
same sample and the same report lines. A deployer points it at the net
they intend to serve and gets a pass/fail report covering

1. **layout** — strict SFv5+ (nnue-pytorch) parse by the port's
   ``NnueWeights.load``, then the port's own compiled native core must
   load the same file (``fc_nnue_load``);
2. **eval parity** — 200 sampled positions (seed 1234): features and
   buckets from the native core, evaluated in one batch by
   ``torch_eval.evaluate_batch`` on the device (on CUDA one dense launch
   of the hand kernel with fused PSQT), must agree BIT-EXACTLY with the
   native scalar evaluator ``fc_nnue_evaluate``;
3. **search parity** — fixed-depth searches through a ``SearchService``
   on the device (``backend="torch"``, the packed kernel on CUDA) and
   through the scalar backend must return identical scores and best
   moves. The device service runs without the bounds tier (as the
   smoke's parity checks do): seeded bound records change what a search
   finds, and the scalar backend has no reuse plane;
4. **material probe** — reports whether the net's eval tracks material
   (nnue_material_correlated), which decides if the full SEE policy
   engages in search (informational).

Any failure names the stage; exit code 0 only when every stage passes.
The device is CUDA unless the caller asks for the CPU (``--device
cpu``), where the evaluator runs the kernel's plain version.
"""

from __future__ import annotations

import asyncio
import contextlib
import ctypes
import os
from typing import Callable, List, Optional

__all__ = ["verify_net", "run_cli"]


def _sample_fens(n: int, seed: int) -> List[str]:
    import random

    from fishnet_tpu_torch.chess import Board

    rng = random.Random(seed)
    fens = []
    while len(fens) < n:
        b = Board()
        for _ in range(rng.randrange(2, 70)):
            if b.outcome() != 0:
                break
            b.push_uci(rng.choice(b.legal_moves()))
        if b.outcome() == 0:
            fens.append(b.fen())
    return fens


@contextlib.contextmanager
def _bounds_tier_off():
    """``FISHNET_NO_BOUNDS=1`` while a service is built (it reads the
    hatch at construction), restored after."""
    old = os.environ.get("FISHNET_NO_BOUNDS")
    os.environ["FISHNET_NO_BOUNDS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["FISHNET_NO_BOUNDS"]
        else:
            os.environ["FISHNET_NO_BOUNDS"] = old


def verify_net(
    path: str,
    positions: int = 200,
    depth: int = 4,
    log: Optional[Callable[[str], None]] = None,
    device=None,
    report: Optional[dict] = None,
) -> bool:
    """Run every stage on ``device`` (None: CUDA; a CUDA request without
    a GPU raises); returns True when all pass. ``log`` receives one
    human-readable line per stage. ``report``, when given, receives the
    sampled ``fens``, the ``device_values`` and ``scalar_values`` of the
    eval stage, and the hand kernel's launches: ``dense`` in the eval
    stage, ``packed`` and the device service's ``dispatches`` after its
    warm-up, and its ``rung``."""
    emit = log or (lambda s: None)
    report = {} if report is None else report
    ok = True

    import torch

    from fishnet_tpu_torch.device import resolve_device

    dev = resolve_device(device)

    # -- stage 1: layout ---------------------------------------------------
    from fishnet_tpu_torch.nnue.weights import NnueWeights

    try:
        weights = NnueWeights.load(path)
        emit(f"layout          PASS  ({path})")
    except Exception as err:  # noqa: BLE001 - report, don't crash
        emit(f"layout          FAIL  {err}")
        return False

    # The native core must accept it too (it is the search-side consumer).
    from fishnet_tpu_torch.chess.core import load as load_lib

    lib = load_lib()
    err_buf = ctypes.create_string_buffer(256)
    net = lib.fc_nnue_load(path.encode(), err_buf, len(err_buf))
    if not net:
        emit(f"scalar load     FAIL  {err_buf.value.decode(errors='replace')}")
        return False
    emit("scalar load     PASS")

    # -- stage 2: scalar vs the device evaluator, bit parity ---------------
    import numpy as np

    from fishnet_tpu_torch.chess import Board
    from fishnet_tpu_torch.nnue import spec
    from fishnet_tpu_torch.nnue.torch_eval import (
        evaluate_batch,
        params_from_weights,
    )
    from fishnet_tpu_torch.ops import ft_gather

    fens = _sample_fens(positions, seed=1234)
    params = params_from_weights(weights, dev)

    feats = np.full(
        (len(fens), 2, spec.MAX_ACTIVE_FEATURES), spec.NUM_FEATURES, np.int32
    )
    buckets = np.empty((len(fens),), np.int32)
    scalar_vals = np.empty((len(fens),), np.int64)
    feat_buf = (ctypes.c_int32 * spec.MAX_ACTIVE_FEATURES)()
    try:
        for i, fen in enumerate(fens):
            board = Board(fen)
            for p in range(2):
                cnt = lib.fc_pos_features(board._pos, p, feat_buf)
                feats[i, p, :cnt] = np.frombuffer(
                    feat_buf, dtype=np.int32, count=cnt)
            buckets[i] = lib.fc_pos_psqt_bucket(board._pos)
            scalar_vals[i] = lib.fc_nnue_evaluate(net, board._pos)
    finally:
        lib.fc_nnue_free(net)

    dense0 = ft_gather.ft_accumulate_cuda.launches
    device_vals = evaluate_batch(
        params, torch.from_numpy(feats).to(dev),
        torch.from_numpy(buckets).to(dev)).cpu().numpy().astype(np.int64)
    report.update(fens=fens, device_values=device_vals,
                  scalar_values=scalar_vals,
                  dense=ft_gather.ft_accumulate_cuda.launches - dense0)
    bad = np.nonzero(device_vals != scalar_vals)[0]
    if bad.size:
        i = int(bad[0])
        emit(
            f"eval parity     FAIL  {bad.size}/{len(fens)} positions differ; "
            f"first: {fens[i]!r} scalar={scalar_vals[i]} "
            f"device={device_vals[i]}"
        )
        ok = False
    else:
        emit(f"eval parity     PASS  ({len(fens)} positions, bit-exact)")

    # -- stage 3: fixed-depth search self-parity ---------------------------
    from fishnet_tpu_torch.search.service import SearchService

    async def search_all(backend: str):
        with _bounds_tier_off():
            svc = SearchService(
                weights=weights, pool_slots=8, batch_capacity=64,
                tt_bytes=64 << 20, backend=backend, device=dev,
            )
        svc.set_prefetch(8, adaptive=False)
        try:
            svc.warmup()
            packed0 = ft_gather.ft_accumulate_packed_cuda.launches
            dispatches0 = svc.counters().get("dispatches", 0)
            out = []
            for fen in fens[: max(10, positions // 10)]:
                r = await svc.search(fen, [], depth=depth)
                line = [l for l in r.lines if l.multipv == 1][-1]
                out.append((line.value, line.is_mate, r.best_move))
            if backend == "torch":
                report.update(
                    packed=ft_gather.ft_accumulate_packed_cuda.launches
                    - packed0,
                    dispatches=svc.counters().get("dispatches", 0)
                    - dispatches0,
                    rung=svc.psqt_path)
            return out
        finally:
            svc.close()

    scalar_search = asyncio.run(search_all("scalar"))
    device_search = asyncio.run(search_all("torch"))
    mismatches = [
        (f, s, j)
        for f, s, j in zip(fens, scalar_search, device_search)
        if s != j
    ]
    if mismatches:
        emit(
            f"search parity   FAIL  {len(mismatches)} diverged at depth "
            f"{depth}; first: {mismatches[0]}"
        )
        ok = False
    else:
        emit(
            f"search parity   PASS  ({len(scalar_search)} searches at "
            f"depth {depth})"
        )

    # -- stage 4: material probe (informational, never fails) --------------
    lib.fc_nnue_material_correlated.argtypes = [ctypes.c_void_p]
    lib.fc_nnue_material_correlated.restype = ctypes.c_int
    net = lib.fc_nnue_load(path.encode(), err_buf, len(err_buf))
    if net:
        correlated = bool(lib.fc_nnue_material_correlated(net))
        lib.fc_nnue_free(net)
        emit(
            "material probe  "
            + (
                "PASS  eval tracks material; full SEE policy engages"
                if correlated
                else "INFO  eval does not track material (random/dev "
                "net?); SEE capture demotion stays off"
            )
        )
    return ok


def run_cli(path: str, device=None, verbose: int = 0) -> int:
    """The command: the stage lines, then ``verify-net: PASS`` or
    ``FAIL``; exit code 0 or 1. With ``verbose``, one last line gives
    the hand kernel's dense launches (eval stage), its packed launches
    and the device service's dispatches after its warm-up, and the
    service's rung."""
    report: dict = {}
    ok = verify_net(path, log=print, device=device, report=report)
    print("verify-net: " + ("PASS" if ok else "FAIL"))
    if verbose:
        print(f"verify-net launches: dense {report.get('dense')}, packed "
              f"{report.get('packed')}, dispatches since warm-up "
              f"{report.get('dispatches')}, rung {report.get('rung')}")
    return 0 if ok else 1
