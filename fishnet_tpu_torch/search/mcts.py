"""Batched PUCT MCTS over the AlphaZero-style policy+value net: the port
of ``fishnet_tpu/search/mcts.py``.

The second search family (BASELINE.json config 5): instead of
alpha-beta fibers suspending for NNUE microbatches (search/service.py),
many PUCT tree searches run concurrently in Python and pool their
pending leaf evaluations into one fixed-shape microbatch per step.
Virtual loss lets each tree contribute several leaves per step (leaf
parallelism), which keeps the device batch full.

The pool drives its microbatches through an EVALUATOR SEAM: by default
leaves ride the shared AZ dispatch plane (search/az_plane.py, on the
port's coalescer and async pipeline) with position-keyed eval reuse
before the wire; ``FISHNET_NO_SHARED_AZ_PLANE=1`` selects the private
single-call evaluator on the same forward. Both give bit-identical
results.

Tree-side scaling: per-tree ADAPTIVE leaf width (the speculative
multi-leaf width widens when the observed collision rate is low and
narrows when virtual loss cannot steer walks apart, as on forced-move
lines), CROSS-MOVE SUBTREE REUSE (a harvested tree is kept in a small
LRU; a later submit for the same game one or two plies deeper rebases
the played-move subtree), and a pool-wide EXPANSION MEMO.

The tree logic is the JAX package's line for line, so the same
evaluator gives the same trees in both packages. Telemetry: the JAX
package's ``fishnet_mcts_*`` families, process-wide totals and live
gauges over every pool (``_collect_mcts_families``), and the
``mcts_collect`` span of each step's leaf collection when telemetry is
on. Left out against it: the control plane's leaf-width actuator (not
ported); the pool also reports through ``counters()``.
"""

from __future__ import annotations

import math
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.chess.board import Board
from fishnet_tpu_torch.models.az import AzConfig, value_to_centipawns
from fishnet_tpu_torch.models.az_encoding import board_planes, legal_policy_indices
from fishnet_tpu_torch.search import eval_cache as _eval_cache
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS

__all__ = ["MctsConfig", "MctsLine", "MctsPool", "MctsResult"]


@dataclass(frozen=True)
class MctsConfig:
    cpuct: float = 1.5
    # Base leaves each search may have in flight per step (virtual-loss
    # width). With ``adaptive_leaves`` this is the STARTING width; the
    # per-tree width then floats in [1, leaves_per_step_max] driven by
    # the observed collision rate.
    leaves_per_step: int = 8
    leaves_per_step_max: int = 32
    adaptive_leaves: bool = True
    # Device microbatch (fixed jit shape; short batches are padded).
    batch_capacity: int = 256
    # Cross-move subtree reuse (harvested-tree LRU; see MctsPool.submit).
    tree_reuse: bool = True
    tree_reuse_cache: int = 32
    # Pool-level expansion memo: position-key -> (priors, value), the
    # TREE-side twin of the dispatch plane's AzEvalCache. A selection
    # walk reaching a position any of this pool's searches already
    # expanded re-expands it IMMEDIATELY from the memo — no plane
    # encode, no dispatch slot, no softmax — which is what lifts warm
    # visit throughput to the tree-walk bound. 0 disables.
    expansion_memo: int = 1 << 17
    az: AzConfig = field(default_factory=AzConfig)


@dataclass
class MctsLine:
    multipv: int  # 1-based rank
    move: str
    value: float
    cp: int
    pv: List[str]


@dataclass
class MctsResult:
    best_move: Optional[str]
    pv: List[str]
    value: float  # root value in [-1, 1], side to move's perspective
    cp: int
    visits: int
    depth: int  # principal-variation length
    time_seconds: float
    lines: List[MctsLine] = field(default_factory=list)
    # Full root visit distribution [(move, visits)], the self-play
    # training policy target.
    root_visits: List[Tuple[str, int]] = field(default_factory=list)


PENDING_CHILD = -2  # edge has an evaluation in flight

#: Collision-rate thresholds and sample window for the adaptive leaf
#: width: above HIGH the tree halves its width (virtual loss cannot
#: steer walks apart — narrow/forced lines), below LOW it doubles (the
#: tree is wide enough to absorb more speculation). Driven purely by
#: tree events, so the width trajectory is identical whichever
#: evaluator the pool runs on — part of the plane-parity contract.
_ADAPT_WINDOW = 32
_ADAPT_HIGH = 0.25
_ADAPT_LOW = 0.05


class _Node:
    __slots__ = ("moves", "priors", "priors_c", "child", "n", "w", "vloss",
                 "terminal")

    def __init__(self, moves: List[str], priors: np.ndarray,
                 terminal: Optional[float], cpuct: float = 1.0) -> None:
        self.moves = moves
        self.priors = priors
        # cpuct folded in once at build time; bit-equal to multiplying
        # per selection step (same left-to-right grouping).
        self.priors_c = cpuct * priors
        k = len(moves)
        self.child = np.full(k, -1, dtype=np.int32)  # -1 = unexpanded
        self.n = np.zeros(k, dtype=np.int64)
        self.w = np.zeros(k, dtype=np.float64)
        self.vloss = np.zeros(k, dtype=np.int32)
        self.terminal = terminal  # value from this node's stm, if game over


def _terminal_value(outcome: int) -> Optional[float]:
    if outcome == Board.ONGOING:
        return None
    if outcome in (Board.CHECKMATE, Board.VARIANT_LOSS):
        return -1.0
    if outcome == Board.VARIANT_WIN:
        return 1.0
    return 0.0  # stalemate / draw


def _position_key(board: Board) -> int:
    """Unsalted AZ eval-reuse key: Zobrist mixed with the halfmove clock
    (plane 17 sees the clock; Zobrist doesn't). The plane XORs the net
    fingerprint on top (search/az_plane.py)."""
    return _eval_cache.az_position_key(
        board.zobrist_hash(), board.halfmove_clock()
    )


class _Search:
    """One PUCT tree. Nodes live in a list; edges hold child ids."""

    def __init__(self, board: Board, visits: int, cfg: MctsConfig,
                 multipv: int = 1) -> None:
        self.root_board = board
        self.cfg = cfg
        self.multipv = max(1, multipv)
        self.budget = max(1, visits)
        self.nodes: List[_Node] = []
        self.started = time.monotonic()
        self.visits_done = 0
        self.stop = False
        # Pending leaf evals: (path of (node_id, edge), planes, moves,
        # stm_white, kind, key, fen). The fen trails the tuple so the
        # pool can build speculative CHILD candidates for the dispatch
        # plane's pad rows (az_plane.offer_speculation) without a
        # second movegen/encode pass.
        self.pending: List[
            Tuple[
                List[Tuple[int, int]], np.ndarray, List[str], bool, str,
                int, str,
            ]
        ] = []
        # The root itself needs an eval before any simulation can run.
        self._root_ready = False
        # Cross-move reuse identity, set by MctsPool.submit.
        self.key: Optional[Tuple[str, Tuple[str, ...]]] = None
        # Pool-shared expansion memo (position key -> (priors, value)),
        # wired up by MctsPool.submit / rebase. None disables.
        self.memo: Optional["OrderedDict[int, Tuple[np.ndarray, float]]"] = None
        self.memo_cap = 0
        self.memo_hits = 0
        self.memo_hits_reported = 0
        # Adaptive virtual-loss width + collision accounting. The
        # ``*_reported`` counters let the pool drain monotone deltas
        # into its process-wide telemetry totals without double counts.
        self.leaf_width = max(1, cfg.leaves_per_step)
        self.collisions = 0
        self.collisions_reported = 0
        self.visits_reported = 0
        self._adapt_walks = 0
        self._adapt_collisions = 0

    # -- tree walking -----------------------------------------------------

    def _select_path(self) -> Optional[Tuple[List[Tuple[int, int]], Board]]:
        """Walk PUCT from the root to a leaf, applying virtual loss.
        Returns None on a collision (the walk reached an edge whose
        evaluation is already in flight) or when it resolved a terminal
        node in place; collisions release their virtual loss."""
        path: List[Tuple[int, int]] = []
        board = self.root_board.copy()
        node_id = 0
        while True:
            node = self.nodes[node_id]
            if node.terminal is not None:
                self._backup(path, node.terminal)
                self.visits_done += 1
                return None
            # nv[e] == 0 implies n == vloss == 0, hence w == 0, so the
            # max(nv, 1) denominator already yields q == 0 on untried
            # edges — no masked select needed. (1.0 + nv) is bit-equal
            # to (1.0 + n) + vloss for exact integer counts.
            nv = node.n + node.vloss
            total = int(nv.sum())
            q = (node.w - node.vloss) / np.maximum(nv, 1)
            u = node.priors_c * (math.sqrt(total + 1) / (1.0 + nv))
            edge = int((q + u).argmax())
            child = node.child[edge]
            if child == PENDING_CHILD:
                # Collision: virtual loss couldn't steer away (e.g. a
                # forced move). Undo this walk and let the step's batch go
                # out; the pending eval will open the subtree.
                for nid, e in path:
                    self.nodes[nid].vloss[e] -= 1
                self.collisions += 1
                self._adapt_collisions += 1
                return None
            path.append((node_id, edge))
            node.vloss[edge] += 1
            board.push_uci(node.moves[edge])
            if child < 0:
                return path, board
            node_id = int(child)

    def _backup(self, path: List[Tuple[int, int]], leaf_value: float) -> None:
        """Propagate a leaf value (leaf stm perspective) up the path,
        releasing the virtual loss the selection walk applied."""
        v = leaf_value
        for node_id, edge in reversed(path):
            v = -v  # child stm -> this node's stm
            node = self.nodes[node_id]
            node.n[edge] += 1
            node.w[edge] += v
            node.vloss[edge] -= 1

    def _adapt(self) -> None:
        """Collision-rate-driven leaf-width update (module constants)."""
        if not self.cfg.adaptive_leaves or self._adapt_walks < _ADAPT_WINDOW:
            return
        rate = self._adapt_collisions / self._adapt_walks
        if rate > _ADAPT_HIGH:
            self.leaf_width = max(1, self.leaf_width // 2)
        elif rate < _ADAPT_LOW:
            self.leaf_width = min(
                max(self.cfg.leaves_per_step_max, self.cfg.leaves_per_step),
                self.leaf_width * 2,
            )
        self._adapt_walks = 0
        self._adapt_collisions = 0

    # -- step api ----------------------------------------------------------

    def collect(self, room: int) -> None:
        """Run selections until min(leaf_width, room) leaves are
        pending (or the visit budget / tree is exhausted)."""
        if not self._root_ready:
            b = self.root_board
            moves = b.legal_moves()
            outcome = b.outcome()
            if outcome != Board.ONGOING or not moves:
                # Terminal root: no network needed, search is over.
                value = _terminal_value(outcome)
                self.nodes.append(
                    _Node([], np.zeros(0, np.float32),
                          value if value is not None else 0.0)
                )
                self._root_ready = True
                return
            if room <= 0:
                return
            key = _position_key(b)
            ent = self.memo.get(key) if self.memo is not None else None
            if ent is None:
                fen = b.fen()
                self.pending.append(
                    ([], board_planes(fen), moves, b.turn() == "w",
                     "root", key, fen)
                )
                return
            # Memoized root: expand in place and keep collecting leaves
            # in this same call.
            self.memo_hits += 1
            self.nodes.append(_Node(moves, ent[1], None, self.cfg.cpuct))
            self._root_ready = True
        width = min(self.leaf_width, room)
        attempts = 0
        max_attempts = self.leaf_width * 4
        while (
            len(self.pending) < width
            and self.visits_done + len(self.pending) < self.budget
            and not self.stop
            and attempts < max_attempts
        ):
            attempts += 1
            self._adapt_walks += 1
            out = self._select_path()
            if out is None:
                continue
            path, board = out
            parent_id, edge = path[-1]
            # Terminal-ness is path-dependent (repetition draws), so the
            # outcome check must run before the position-keyed memo probe.
            outcome = board.outcome()
            if outcome != Board.ONGOING:
                value = _terminal_value(outcome)
                node = _Node([], np.zeros(0, np.float32),
                             value if value is not None else 0.0)
                self.nodes.append(node)
                self.nodes[parent_id].child[edge] = len(self.nodes) - 1
                self._backup(path, node.terminal or 0.0)
                self.visits_done += 1
                continue
            key = _position_key(board)
            ent = self.memo.get(key) if self.memo is not None else None
            if ent is not None:
                # Expansion memo hit: this position was already evaluated
                # by some search in the pool. Expand immediately — the
                # visit completes without an eval slot, a plane encode,
                # movegen, or a softmax (moves list and priors array are
                # shared across nodes; neither is ever mutated).
                self.memo_hits += 1
                node = _Node(ent[0], ent[1], None, self.cfg.cpuct)
                self.nodes.append(node)
                self.nodes[parent_id].child[edge] = len(self.nodes) - 1
                self._backup(path, ent[2])
                self.visits_done += 1
                continue
            moves = board.legal_moves()
            if not moves:
                # Defensive: ONGOING with no legal moves (should be
                # covered by outcome(), kept from the pre-memo code).
                node = _Node([], np.zeros(0, np.float32), 0.0)
                self.nodes.append(node)
                self.nodes[parent_id].child[edge] = len(self.nodes) - 1
                self._backup(path, 0.0)
                self.visits_done += 1
                continue
            self.nodes[parent_id].child[edge] = PENDING_CHILD
            fen = board.fen()
            self.pending.append((path, board_planes(fen), moves,
                                 board.turn() == "w", "leaf", key, fen))
        self._adapt()

    def apply_evals(self, results: List[Tuple[np.ndarray, float]]) -> None:
        """results[i] = (policy_logits [4672], value) for self.pending[i]."""
        memo = self.memo
        for (path, _planes, moves, stm_white, kind, key, _fen), (
            logits, value,
        ) in zip(self.pending, results):
            idx = legal_policy_indices(moves, stm_white)
            logit = logits[idx]
            if logit.size:
                logit = logit - logit.max()
                priors = np.exp(logit)
                priors /= priors.sum()
            else:
                priors = logit
            node = _Node(moves, priors.astype(np.float32), None,
                         self.cfg.cpuct)
            if memo is not None and key not in memo:
                # Moves and priors are pure functions of the position so
                # sharing them across nodes preserves bit-parity; nodes
                # never mutate either. FIFO-evicted at cap.
                memo[key] = (moves, node.priors, float(value))
                if len(memo) > self.memo_cap:
                    memo.popitem(last=False)
            self.nodes.append(node)
            node_id = len(self.nodes) - 1
            if kind == "root":
                assert node_id == 0
                self._root_ready = True
            else:
                parent_id, edge = path[-1]
                self.nodes[parent_id].child[edge] = node_id
                self._backup(path, float(value))
                self.visits_done += 1
        self.pending = []

    # -- cross-move reuse --------------------------------------------------

    def rebase(self, played: List[str], board: Board, visits: int,
               multipv: int = 1) -> Optional["_Search"]:
        """Build a FRESH search whose tree is this one's subtree after
        ``played`` (the moves the game advanced by since this tree's
        root). Returns None when the subtree can't seed a new search —
        an unexpanded/pending edge on the played line, a terminal new
        root, or a tree that never finished its root eval.

        The rebased tree keeps visit counts, values and priors (the
        expensive accumulated knowledge) but gets clean virtual-loss
        arrays and in-flight markers: PENDING_CHILD edges become
        unexpanded (-1), so a tree harvested mid-flight (stop) rebases
        safely."""
        if not self._root_ready or not self.nodes:
            return None
        node_id = 0
        for mv in played:
            node = self.nodes[node_id]
            if node.terminal is not None or not node.moves:
                return None
            try:
                edge = node.moves.index(mv)
            except ValueError:
                return None
            child = int(node.child[edge])
            if child < 0:  # unexpanded or pending: nothing to reuse
                return None
            node_id = child
        if self.nodes[node_id].terminal is not None:
            return None
        # BFS renumber so the subtree is dense with its root at 0.
        mapping = {node_id: 0}
        order = [node_id]
        i = 0
        while i < len(order):
            for c in self.nodes[order[i]].child:
                ci = int(c)
                if ci >= 0 and ci not in mapping:
                    mapping[ci] = len(order)
                    order.append(ci)
            i += 1
        fresh = _Search(board, visits, self.cfg, multipv=multipv)
        fresh._root_ready = True
        fresh.memo = self.memo
        fresh.memo_cap = self.memo_cap
        for nid in order:
            old = self.nodes[nid]
            node = _Node(old.moves, old.priors, old.terminal,
                         self.cfg.cpuct)
            node.n = old.n
            node.w = old.w
            node.child = np.array(
                [mapping[int(c)] if int(c) >= 0 else -1 for c in old.child],
                dtype=np.int32,
            )
            fresh.nodes.append(node)
        return fresh

    @property
    def done(self) -> bool:
        if not self._root_ready:
            return False
        if self.nodes[0].terminal is not None or not self.nodes[0].moves:
            return True
        return self.stop or self.visits_done >= self.budget

    def result(self) -> MctsResult:
        elapsed = time.monotonic() - self.started
        if not self.nodes or not self.nodes[0].moves:
            # Terminal root: surface the terminal value (mate = -1, draw = 0).
            value = 0.0
            if self.nodes and self.nodes[0].terminal is not None:
                value = self.nodes[0].terminal
            return MctsResult(None, [], value, value_to_centipawns(value),
                              self.visits_done, 0, elapsed)
        root = self.nodes[0]

        def edge_pv(first_edge: int) -> List[str]:
            pv = [root.moves[first_edge]]
            node_id = int(root.child[first_edge])
            while 0 <= node_id < len(self.nodes):
                node = self.nodes[node_id]
                if not node.moves or node.n.sum() == 0:
                    break
                edge = int(np.argmax(node.n))
                pv.append(node.moves[edge])
                node_id = int(node.child[edge])
            return pv

        def edge_value(edge: int) -> float:
            n = root.n[edge]
            # Zero-visit fallback (stopped early): neutral value; the
            # ordering below falls back to the policy prior.
            return float(root.w[edge] / n) if n > 0 else 0.0

        # Rank edges by visits, tie-broken by prior — at zero visits
        # everywhere (stopped before the first backup) this degrades to
        # the raw policy ordering instead of move-generation order.
        order = np.lexsort((root.priors, root.n))[::-1]
        k = min(self.multipv, len(root.moves))
        lines = []
        for rank, edge in enumerate(order[:k], start=1):
            v = edge_value(int(edge))
            lines.append(MctsLine(
                multipv=rank, move=root.moves[int(edge)], value=v,
                cp=value_to_centipawns(v), pv=edge_pv(int(edge)),
            ))
        best = lines[0]
        return MctsResult(
            best_move=best.move,
            pv=best.pv,
            value=best.value,
            cp=best.cp,
            visits=self.visits_done,
            depth=len(best.pv),
            time_seconds=elapsed,
            lines=lines,
            root_visits=[(m, int(n)) for m, n in zip(root.moves, root.n)],
        )


# -- evaluators (the seam) ---------------------------------------------------


class _LocalAzEvaluator:
    """The private single-device evaluator behind the
    ``FISHNET_NO_SHARED_AZ_PLANE=1`` hatch (and the deterministic
    reference of the parity tests): one forward of the whole
    fixed-capacity buffer per pool step, no coalescing, no eval reuse.
    The wire is the plane's: uint8 planes up (plane 17 carries the
    halfmove clock x100), fp16 logits and float32 values back."""

    def __init__(self, params: Dict, cfg: "MctsConfig", device=None) -> None:
        import torch

        from fishnet_tpu_torch.models.az import params_from_jax, wire_forward
        from fishnet_tpu_torch.search.az_plane import configure_backends

        self._torch = torch
        self._device = configure_backends(device)
        self._net = params_from_jax(params, self._device)
        self._forward = wire_forward

    def _run(self, planes_u8: np.ndarray):
        torch = self._torch
        x = torch.from_numpy(planes_u8).to(self._device)
        logits, values = self._forward(self._net, x)
        return logits.cpu().numpy(), values.cpu().numpy()

    def warmup(self, cap: int) -> None:
        self._run(np.zeros((cap, 8, 8, 19), np.uint8))

    def evaluate(self, planes_u8: np.ndarray, n: int,
                 keys=None) -> Tuple[np.ndarray, np.ndarray]:
        logits, values = self._run(planes_u8)
        return logits[:n].astype(np.float32), values[:n]

    def close(self) -> None:
        pass

class _PlaneEvaluator:
    """Adapter binding one MctsPool to one coalesce lane of a (possibly
    shared) AzDispatchPlane."""

    def __init__(self, plane, lane: int, owns_plane: bool) -> None:
        self.plane = plane
        self.lane = lane
        self._owns = owns_plane

    def warmup(self, cap: int) -> None:
        self.plane.warmup()

    def evaluate(self, planes_u8: np.ndarray, n: int,
                 keys=None) -> Tuple[np.ndarray, np.ndarray]:
        return self.plane.evaluate(self.lane, planes_u8, n, keys)

    def counters(self) -> Dict:
        return self.plane.counters()

    def close(self) -> None:
        if self._owns:
            self.plane.close()



# -- pool-level telemetry (process-wide, across pools) ----------------------

_TEL_LOCK = threading.Lock()
_TOTALS = {"visits": 0, "collisions": 0, "reuse": 0}
_POOLS: "weakref.WeakSet[MctsPool]" = weakref.WeakSet()
_collector_on = False


def _collect_mcts_families():
    """Registry collector for the MCTS tree-side families: process-wide
    monotone totals plus live gauges summed over every live pool.
    Registered on first pool construction, never unregistered — totals
    outlive pools the way dispatch counters outlive services."""
    from fishnet_tpu_torch.telemetry.registry import counter_family, gauge_family

    with _TEL_LOCK:
        visits = _TOTALS["visits"]
        collisions = _TOTALS["collisions"]
        reuse = _TOTALS["reuse"]
        pools = list(_POOLS)
    trees = 0
    fills = []
    for pool in pools:
        trees += pool.active()
        if pool._fill_ema is not None:
            fills.append(pool._fill_ema)
    fill = sum(fills) / len(fills) if fills else 0.0
    return [
        counter_family(
            "fishnet_mcts_visits_total",
            "Completed MCTS visits (backups) across all pools.",
            visits,
        ),
        counter_family(
            "fishnet_mcts_collisions_total",
            "Selection walks that hit an in-flight edge and released "
            "their virtual loss.",
            collisions,
        ),
        counter_family(
            "fishnet_mcts_subtree_reuse_total",
            "Submitted searches seeded by rebasing a harvested tree.",
            reuse,
        ),
        gauge_family(
            "fishnet_mcts_batch_fill_ratio",
            "EMA of evaluated leaves per step over batch capacity "
            "(mean across live pools).",
            fill,
        ),
        gauge_family(
            "fishnet_mcts_trees_active",
            "Unfinished searches across all live pools.",
            trees,
        ),
    ]


class MctsPool:
    """Many concurrent PUCT searches sharing one evaluator.

    Synchronous core: callers submit searches, then drive ``step()`` until
    ``active() == 0``. The async engine wrapper (engine/az_engine.py)
    runs this on a driver thread, mirroring SearchService's topology.

    ``params`` is the JAX-layout dict of numpy arrays (models/az.py).
    ``evaluator`` picks the dispatch path: None (default) builds the
    shared AZ dispatch plane on ``device`` (``cuda`` unless the caller
    asks for the CPU) — or the private evaluator when
    ``FISHNET_NO_SHARED_AZ_PLANE=1``; an ``AzDispatchPlane`` instance
    registers a lane on it (several pools, one plane); any object with
    ``evaluate(planes_u8, n, keys) -> (logits_f32, values_f32)`` works
    (the tests inject deterministic fakes through this). ``devices``:
    the shards of the plane this pool builds (``AzDispatchPlane``'s
    ``devices``)."""

    def __init__(self, params: Dict, cfg: MctsConfig = MctsConfig(),
                 evaluator=None, device=None, devices=None) -> None:
        self.cfg = cfg
        self.params = params
        if evaluator is None:
            if os.environ.get("FISHNET_NO_SHARED_AZ_PLANE", "") == "1":
                evaluator = _LocalAzEvaluator(params, cfg, device)
            else:
                from fishnet_tpu_torch.search.az_plane import AzDispatchPlane

                plane = AzDispatchPlane(params, cfg, device=device,
                                        devices=devices)
                evaluator = _PlaneEvaluator(
                    plane, plane.register_lane(), owns_plane=True
                )
        elif hasattr(evaluator, "register_lane"):
            evaluator = _PlaneEvaluator(
                evaluator, evaluator.register_lane(), owns_plane=False
            )
        self._evaluator = evaluator
        self._searches: Dict[int, _Search] = {}
        self._next_id = 0
        self._rr_cursor = 0
        self._lock = threading.Lock()
        # ONE preallocated wire buffer, sliced per step (a per-step
        # full-capacity allocation is measurable at large capacities).
        # Padding rows beyond the step's fill are stale — harmless, the
        # AZ net is per-row independent.
        self._batch_buf = np.zeros(
            (cfg.batch_capacity, 8, 8, 19), np.uint8
        )
        # Harvested-tree LRU for cross-move subtree reuse, keyed by the
        # submit identity (root fen, moves tuple).
        self._reuse: "OrderedDict[Tuple[str, Tuple[str, ...]], _Search]" = (
            OrderedDict()
        )
        self._reuse_hits = 0
        # Pool-wide expansion memo (see MctsConfig.expansion_memo). Only
        # ever touched from the pool's single step/driver thread.
        memo_cap = (
            0
            if os.environ.get("FISHNET_NO_EXPANSION_MEMO", "") == "1"
            else max(0, cfg.expansion_memo)
        )
        self._memo: Optional[OrderedDict] = OrderedDict() if memo_cap else None
        self._memo_cap = memo_cap
        self._memo_hits = 0
        self._fill_ema: Optional[float] = None
        self._visits = 0
        self._collisions = 0
        self._evals = 0
        self._steps = 0
        self._spec_offered = 0
        global _collector_on
        with _TEL_LOCK:
            _POOLS.add(self)
            if not _collector_on:
                from fishnet_tpu_torch.telemetry.registry import REGISTRY

                REGISTRY.register_collector(
                    _collect_mcts_families, name="mcts-pool"
                )
                _collector_on = True

    def warmup(self) -> None:
        self._evaluator.warmup(self.cfg.batch_capacity)

    # -- the control plane's actuation seam (fishnet_tpu_torch/control) --

    def leaf_width_max(self) -> int:
        return self.cfg.leaves_per_step_max

    def set_leaf_width_max(self, width: int) -> None:
        """Re-bound the AIMD leaf-width ceiling. Live and reused searches
        adopt it at once (a width above it is clamped down); the
        collision-driven AIMD keeps floating underneath. Only the
        ceiling moves, so a search's result stays a function of the
        same visit budget."""
        width = max(1, int(width))
        with self._lock:
            self.cfg = replace(self.cfg, leaves_per_step_max=width)
            cap = max(width, self.cfg.leaves_per_step)
            for s in list(self._searches.values()) + list(
                self._reuse.values()
            ):
                s.cfg = self.cfg
                if s.leaf_width > cap:
                    s.leaf_width = cap

    def close(self) -> None:
        """Release the evaluator (the plane's pipelines when this pool
        owns its plane). Idempotent; the pool must not step after."""
        ev, self._evaluator = self._evaluator, None
        if ev is not None:
            ev.close()

    def _reuse_on(self) -> bool:
        return (
            self.cfg.tree_reuse
            and os.environ.get("FISHNET_NO_SUBTREE_REUSE", "") != "1"
        )

    def submit(self, fen: str, moves: List[str], visits: int,
               multipv: int = 1) -> int:
        board = Board(fen)
        for m in moves:
            board.push_uci(m)
        search = None
        if self._reuse_on() and moves:
            stored = None
            played: List[str] = []
            with self._lock:
                # A game usually advances one ply (analysis) or one
                # full move (self-play both sides run in one pool), so
                # probe the one- and two-ply ancestors.
                for back in (1, 2):
                    if len(moves) >= back:
                        stored = self._reuse.pop(
                            (fen, tuple(moves[:-back])), None
                        )
                        if stored is not None:
                            played = list(moves[-back:])
                            break
            if stored is not None:
                search = stored.rebase(played, board, visits, multipv)
                if search is not None:
                    self._reuse_hits += 1
                    with _TEL_LOCK:
                        _TOTALS["reuse"] += 1
        if search is None:
            search = _Search(board, visits, self.cfg, multipv=multipv)
        search.key = (fen, tuple(moves))
        search.memo = self._memo
        search.memo_cap = self._memo_cap
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._searches[sid] = search
        return sid

    def stop_search(self, sid: int) -> None:
        with self._lock:
            search = self._searches.get(sid)
        if search is not None:
            search.stop = True

    def _drain_counters(self, s: _Search) -> Tuple[int, int]:
        """Move a search's visit/collision deltas into the pool's totals
        (monotone; safe to call any number of times)."""
        dv = s.visits_done - s.visits_reported
        dc = s.collisions - s.collisions_reported
        dm = s.memo_hits - s.memo_hits_reported
        s.visits_reported = s.visits_done
        s.collisions_reported = s.collisions
        s.memo_hits_reported = s.memo_hits
        if dm:
            self._memo_hits += dm
        self._visits += dv
        self._collisions += dc
        if dv or dc:
            with _TEL_LOCK:
                _TOTALS["visits"] += dv
                _TOTALS["collisions"] += dc
        return dv, dc

    def step(self) -> int:
        """One collect -> evaluate -> expand cycle. Returns the number of
        leaves evaluated (0 when all searches are done/idle)."""
        with self._lock:
            searches = list(self._searches.values())
            start = self._rr_cursor
        # Rotate the service order so over-capacity steps don't starve
        # late-submitted searches (head-of-line fairness, like the fiber
        # pool's rr_cursor).
        searches = searches[start % max(1, len(searches)):] + \
            searches[: start % max(1, len(searches))]
        contributors: List[Tuple[_Search, int]] = []  # (search, leaf count)
        planes_list: List[np.ndarray] = []
        keys: List[int] = []
        cap = self.cfg.batch_capacity
        served = 0
        tel = _telemetry.enabled()
        t0 = time.monotonic() if tel else 0.0
        step_collisions = 0
        for s in searches:
            if s.done:
                served += 1
                continue
            room = cap - len(planes_list)
            if room <= 0:
                break
            s.collect(room=room)
            served += 1
            step_collisions += self._drain_counters(s)[1]
            if s.pending:
                contributors.append((s, len(s.pending)))
                for item in s.pending:
                    planes_list.append(item[1])
                    keys.append(item[5])
        with self._lock:
            self._rr_cursor = (start + max(1, served)) % max(1, len(searches))

        if not planes_list:
            return 0
        n_used = len(planes_list)
        if tel:
            _SPANS.record(
                "mcts_collect", t0,
                n=n_used, trees=len(contributors),
                collisions=step_collisions,
            )

        batch = self._batch_buf
        stacked = np.stack(planes_list)
        u8 = stacked.astype(np.uint8)
        # Clip before the uint8 assignment: halfmove clocks above 2.55
        # (clock > 255 in arbitrary analysis FENs) would otherwise wrap
        # modulo 256 and silently corrupt the plane.
        u8[..., 17] = np.clip(np.rint(stacked[..., 17] * 100.0), 0, 255)
        batch[:n_used] = u8
        logits, values = self._evaluator.evaluate(batch, n_used, keys)

        cursor = 0
        spec_plane = self._spec_plane()
        spec_src: List[Tuple[str, List[str], bool, np.ndarray]] = []
        for s, k in contributors:
            results = [
                (logits[cursor + j], float(values[cursor + j])) for j in range(k)
            ]
            cursor += k
            if spec_plane is not None:
                # Capture (fen, moves, stm, logits) before apply_evals
                # clears pending: the evaluated leaves' TOP-PRIOR
                # children are the positions selection reaches next.
                for j, item in enumerate(s.pending):
                    spec_src.append(
                        (item[6], item[2], item[3], results[j][0])
                    )
            s.apply_evals(results)
            self._drain_counters(s)
        if spec_plane is not None and spec_src:
            self._offer_speculation(spec_plane, spec_src)
        self._evals += n_used
        self._steps += 1
        fill = n_used / cap
        self._fill_ema = (
            fill if self._fill_ema is None
            else 0.9 * self._fill_ema + 0.1 * fill
        )
        return n_used

    # -- speculative pad-row candidates (az_plane) -------------------------

    def _spec_plane(self):
        """The shared dispatch plane, when it accepts speculation right
        now (hatch off, budget > 0) — else None. Read per step so the
        control plane's budget actuation and the env hatch both take
        effect between steps without re-wiring the evaluator."""
        plane = getattr(self._evaluator, "plane", None)
        if plane is None or not hasattr(plane, "offer_speculation"):
            return None
        from fishnet_tpu_torch.search.az_plane import speculation_disabled

        if speculation_disabled() or plane.speculation_budget() <= 0:
            return None
        return plane

    def _offer_speculation(self, plane, src) -> None:
        """Build child candidates from this step's evaluated leaves and
        queue them for the plane's pad rows. Ranked by policy prior —
        the AZ analog of miss-history ranking: the highest-prior child
        of a just-expanded node is the position PUCT selects next, so
        it is the likeliest future cache probe. Bounded at 2x the
        budget per step; encode cost stays a handful of boards."""
        budget = plane.speculation_budget()
        ranked: List[Tuple[float, str, str]] = []
        for fen, moves, stm_white, logits in src:
            idx = legal_policy_indices(moves, stm_white)
            if not len(idx):
                continue
            lg = logits[idx]
            lg = lg - lg.max()
            p = np.exp(lg)
            p /= p.sum()
            j = int(p.argmax())
            ranked.append((float(p[j]), fen, moves[j]))
        ranked.sort(key=lambda t: -t[0])
        rows: List[np.ndarray] = []
        keys: List[int] = []
        for _prob, fen, move in ranked[: max(1, 2 * budget)]:
            board = Board(fen)
            try:
                board.push_uci(move)
            except ValueError:
                continue
            if board.outcome() != Board.ONGOING:
                continue
            planes = board_planes(board.fen())
            u8 = planes.astype(np.uint8)
            u8[..., 17] = np.clip(
                np.rint(planes[..., 17] * 100.0), 0, 255
            )
            rows.append(u8)
            keys.append(_position_key(board))
        if rows:
            self._spec_offered += plane.offer_speculation(
                np.stack(rows), keys
            )

    def finished(self) -> List[int]:
        with self._lock:
            return [sid for sid, s in self._searches.items() if s.done]

    def harvest(self, sid: int) -> MctsResult:
        with self._lock:
            search = self._searches.pop(sid)
        self._drain_counters(search)
        result = search.result()
        if (
            self._reuse_on()
            and search.key is not None
            and search.nodes
            and search.nodes[0].moves
        ):
            with self._lock:
                self._reuse[search.key] = search
                self._reuse.move_to_end(search.key)
                while len(self._reuse) > max(1, self.cfg.tree_reuse_cache):
                    self._reuse.popitem(last=False)
        return result

    def active(self) -> int:
        with self._lock:
            return sum(0 if s.done else 1 for s in self._searches.values())

    def counters(self) -> Dict:
        """Tree- and dispatch-side stats (``dispatch``: the evaluator's,
        when it keeps any)."""
        out: Dict = {
            "visits": self._visits,
            "collisions": self._collisions,
            "evals": self._evals,
            "steps": self._steps,
            "fill_ema": self._fill_ema or 0.0,
            "reuse_hits": self._reuse_hits,
            "memo_hits": self._memo_hits,
            "memo_entries": len(self._memo) if self._memo is not None else 0,
            "spec_offered": self._spec_offered,
        }
        ev = self._evaluator
        if ev is not None and hasattr(ev, "counters"):
            out["dispatch"] = ev.counters()
        return out
