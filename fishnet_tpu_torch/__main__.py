"""Command line of the PyTorch/CUDA port.

``python -m fishnet_tpu_torch uci [--device cuda|cpu]`` serves the
batched NNUE search over UCI on stdin/stdout — the port of the JAX
package's ``uci`` command (fishnet_tpu/__main__.py), with the same
flags. Logging goes to stderr: stdout belongs to the protocol.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from typing import List, Optional

from fishnet_tpu_torch.version import __version__


def _log(message: str) -> None:
    sys.stderr.write(message + "\n")
    sys.stderr.flush()


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fishnet_tpu_torch",
        description=f"fishnet-tpu-torch {__version__}: batched NNUE "
                    "search on an NVIDIA GPU.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    uci = sub.add_parser("uci", help="Serve the engine over UCI (stdin/stdout).")
    uci.add_argument("--nnue-file",
                     help="HalfKAv2_hm .nnue weights (default: random, seed 0).")
    uci.add_argument("--microbatch", type=int, default=1024,
                     help="Eval microbatch size across a driver thread's "
                          "pipeline groups (default 1024).")
    uci.add_argument("--pipeline", type=int, default=None,
                     help="In-flight device batches per driver thread "
                          "(default 2).")
    uci.add_argument("--search-threads", type=int, default=1,
                     help="Driver threads stepping the search pool (default 1).")
    uci.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="Where the evaluator runs (default cuda; no GPU "
                          "is an error, never a silent CPU run).")
    # Accepted for command-line compatibility with the JAX package's
    # `uci`; they configure its client, which this command does not run.
    uci.add_argument("--no-conf", action="store_true", help=argparse.SUPPRESS)
    uci.add_argument("--no-stats-file", action="store_true",
                     help=argparse.SUPPRESS)
    uci.add_argument("-v", "--verbose", action="count", default=0,
                     help=argparse.SUPPRESS)
    return parser


def build_search_service(args: argparse.Namespace):
    """The batched-search backend from the ``uci`` options (random
    weights, seed 0, when no --nnue-file is given). Without --pipeline
    the depth is 2: the host phase of one group (fiber stepping, feature
    extraction) overlaps the other group's device work."""
    from fishnet_tpu_torch.device import resolve_device
    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.search.service import SearchService

    for flag in ("microbatch", "pipeline", "search_threads"):
        value = getattr(args, flag)
        if value is not None and value < 1:
            raise ValueError(f"--{flag.replace('_', '-')} must be >= 1")
    device = resolve_device(args.device)  # no GPU: fail before any work
    if args.nnue_file:
        weights = NnueWeights.load(args.nnue_file)
    else:
        _log("W: No --nnue-file given; using random NNUE weights (dev mode).")
        weights = NnueWeights.random(seed=0)
    depth = args.pipeline if args.pipeline is not None else 2
    _log(f"I: Pipelining {depth} eval batches on {device}.")
    return SearchService(
        weights=weights,
        net_path=args.nnue_file,  # the native pool reads the original file
        batch_capacity=args.microbatch,
        pipeline_depth=depth,
        driver_threads=args.search_threads,
        device=device,
    )


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "uci":
        from fishnet_tpu_torch.uci_server import serve

        try:
            service = build_search_service(args)
        except (ValueError, RuntimeError, OSError) as err:
            _log(f"E: {err}")
            return 2
        try:
            asyncio.run(serve(service))
        except KeyboardInterrupt:
            pass
        finally:
            service.close()
        return 0
    return 2  # pragma: no cover - argparse requires a command


if __name__ == "__main__":
    sys.exit(main())
