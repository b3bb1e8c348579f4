"""State-space partitioning (orderings of the compressed state set).

Counterpart of ``pacmensl_tpu/statespace/partitioner.py`` (numpy and scipy
only; the reference's ``src/Partitioner/StatePartitioner*.{h,cpp}``).  The
reference drives Zoltan to assign states to MPI ranks and migrate them;
here an assignment is a **state ordering** plus contiguous **block
boundaries**:

* ``BLOCK``       -- equal state counts per part, the insertion order
  (reference BLOCK, StatePartitionerBase.cpp:36-67);
* ``GRAPH``       -- reverse Cuthill-McKee order of the CME reachability
  graph (the role ParMETIS plays in StatePartitionerGraph.cpp:50-153),
  blocks weighted by per-state matvec FLOPs;
* ``HYPERGRAPH``  -- the reference's connectivity-cut model
  (StatePartitionerHyperGraph.cpp:90-141) relaxed to a spectral
  (Fiedler-vector) order, net-size weights; RCM where the eigensolve
  fails.  Unlike the reference's (ARPACK from a random start), the
  order is the same on every call: a fixed start, and a stated rule
  where the Fiedler eigenvalue is tied (:meth:`StatePartitioner.
  _fiedler_order`).
* ``HIERARCHICAL`` raises, as in the reference.

Approaches (reference ``PartitioningApproach``): ``FROMSCRATCH``
recomputes the order; ``REPARTITION``/``REFINE`` keep it and move only the
boundaries.  On one device the port uses only the ordering: it sets the
compressed operator's memory locality (``fsp/solver.py``'s
``_maybe_partition``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np

#: HYPERGRAPH's eigenpairs: 0, the Fiedler value and two more, to see a
#: tie of the Fiedler value with up to two others
FIEDLER_PAIRS = 4
#: eigenvalues within this relative distance of the Fiedler value are tied
TIE_RTOL = 1.0e-6
#: the directions HYPERGRAPH's tie rule tries in a tied eigenspace
TIE_ANGLES = 16


class PartitioningType(enum.Enum):
    BLOCK = "block"
    GRAPH = "graph"
    HYPERGRAPH = "hyper_graph"
    HIERARCHICAL = "hierarchical"   # declared but unsupported, as reference

    @classmethod
    def from_string(cls, s: str) -> "PartitioningType":
        s = s.strip().lower()
        for v in cls:
            if v.value == s or v.name.lower() == s:
                return v
        raise ValueError(f"unknown partitioning type {s!r}")


class PartitioningApproach(enum.Enum):
    FROMSCRATCH = "from_scratch"
    REPARTITION = "repart"
    REFINE = "refine"

    @classmethod
    def from_string(cls, s: str) -> "PartitioningApproach":
        s = s.strip().lower()
        for v in cls:
            if v.value == s or v.name.lower() == s:
                return v
        raise ValueError(f"unknown partitioning approach {s!r}")


@dataclass
class PartitionResult:
    order: np.ndarray        # permutation of state indices (new ordering)
    boundaries: np.ndarray   # shard boundary offsets, len n_parts+1


class StatePartitioner:
    """Facade dispatching on PartitioningType (reference StatePartitioner)."""

    def __init__(self,
                 ptype: PartitioningType = PartitioningType.BLOCK,
                 approach: PartitioningApproach = PartitioningApproach.FROMSCRATCH):
        if ptype == PartitioningType.HIERARCHICAL:
            raise ValueError("HIERARCHICAL partitioning is not supported "
                             "(unsupported in the reference as well)")
        self.ptype = ptype
        self.approach = approach

    def partition(self,
                  states: np.ndarray,
                  stoich: np.ndarray,
                  n_parts: int,
                  state2index=None,
                  prev_order: Optional[np.ndarray] = None,
                  need_boundaries: bool = True) -> PartitionResult:
        """``need_boundaries=False`` skips the per-state weight sweep
        (about R directory probes per state) and returns equal-count
        boundaries, for callers that use only the ordering."""
        n = states.shape[0]
        if n == 0 or (n_parts <= 1
                      and self.ptype == PartitioningType.BLOCK):
            return PartitionResult(np.arange(n), np.array([0, n]))
        # one part still gets the locality ordering of GRAPH and
        # HYPERGRAPH: it serves the operator's gathers, not only balance

        hyper = self.ptype == PartitioningType.HYPERGRAPH
        if self.ptype == PartitioningType.BLOCK:
            order = np.arange(n)
            weights = np.ones(n)
        else:
            if self.approach != PartitioningApproach.FROMSCRATCH and \
                    prev_order is not None and prev_order.shape[0] == n:
                order = prev_order      # keep ordering, move boundaries only
            else:
                order = self._locality_order(
                    states, stoich, state2index,
                    objective="connectivity" if hyper else "bandwidth",
                    n_parts=n_parts)
            if not need_boundaries:
                return PartitionResult(
                    order, self._weighted_blocks(np.ones(n), n_parts))
            weights = (self._net_weights(states, stoich, state2index)
                       if hyper
                       else self._flop_weights(states, stoich, state2index))
            weights = weights[order]

        boundaries = self._weighted_blocks(weights, n_parts)
        return PartitionResult(order, boundaries)

    # ------------------------------------------------------------ pieces
    @staticmethod
    def _flop_weights(states, stoich, state2index) -> np.ndarray:
        """Per-state matvec cost, mirroring the reference's vertex weights
        (~2 flops per nonzero; StatePartitionerGraph.cpp:71-87)."""
        n, m = states.shape[0], stoich.shape[0]
        w = np.full(n, 2.0 * m + m, dtype=np.float64)
        if state2index is not None:
            for r in range(m):
                nbr = states - stoich[r][None, :]
                w += (state2index(nbr) >= 0).astype(np.float64)
        return w

    @staticmethod
    def _net_weights(states, stoich, state2index) -> np.ndarray:
        """Per-state hyperedge size (compressed-vertex format): |{x} union
        in-neighbors| — the reference PHG model's net sizes
        (StatePartitionerHyperGraph.cpp:113-141)."""
        n, m = states.shape[0], stoich.shape[0]
        w = np.ones(n, dtype=np.float64)
        if state2index is not None:
            for r in range(m):
                nbr = states - stoich[r][None, :]
                w += (state2index(nbr) >= 0).astype(np.float64)
        return w

    @staticmethod
    def _adjacency(states, stoich, state2index):
        """Symmetrized CME reachability graph (scipy CSR), or None."""
        n, m = states.shape[0], stoich.shape[0]
        try:
            import scipy.sparse as sp
        except ImportError:
            return None
        rows, cols = [], []
        for r in range(m):
            nbr = state2index(states - stoich[r][None, :])
            src = np.nonzero(nbr >= 0)[0]
            rows.append(src)
            cols.append(nbr[src])
        rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
        g = sp.coo_matrix((np.ones(rows.shape[0]), (rows, cols)),
                          shape=(n, n)).tocsr()
        return g + g.T

    @staticmethod
    def _locality_order(states, stoich, state2index,
                        objective: str = "bandwidth",
                        n_parts: int = 1) -> np.ndarray:
        """Ordering of the CME dependency graph so a contiguous 1-D split
        has a small boundary cut.

        ``bandwidth`` (GRAPH): reverse-Cuthill-McKee.
        ``connectivity`` (HYPERGRAPH): Fiedler-vector (spectral) order —
        minimizes sum_edges (pos_i - pos_j)^2, the continuous relaxation
        of the PHG connectivity-cut objective (:meth:`_fiedler_order`, whose
        choice on a tie reads ``n_parts``); falls back to RCM when the
        eigensolve fails or scipy is unavailable.  Both are the same on
        every call and every rank.
        """
        n = states.shape[0]
        if state2index is None:
            return np.arange(n)
        g = StatePartitioner._adjacency(states, stoich, state2index)
        if g is None:
            return np.arange(n)
        if objective == "connectivity" and n > 2:
            try:
                return StatePartitioner._fiedler_order(
                    g, states, stoich, state2index, n_parts)
            except Exception:
                pass                      # spectral failed: RCM fallback
        try:
            from scipy.sparse.csgraph import reverse_cuthill_mckee
        except ImportError:          # host-side dependency only; fallback
            return np.arange(n)
        perm = reverse_cuthill_mckee(g, symmetric_mode=True)
        return np.asarray(perm, dtype=np.int64)

    @staticmethod
    def _fiedler_order(g, states, stoich, state2index, n_parts
                       ) -> np.ndarray:
        """The order of the Fiedler vector of ``g``'s Laplacian, the same
        on every call and every rank.  ARPACK starts from a fixed vector
        (the reference's from a random one).  Where the Fiedler eigenvalue
        is tied (the toggle's square grid: one eigenvalue per axis), the
        eigenspace holds no preferred vector, so a rule picks one:

        1. a basis of the tied space independent of ARPACK's: the
           projections of the species' coordinates onto it, in species
           order, orthonormalised (ARPACK's vectors complete it where the
           coordinates span less);
        2. in the plane of its first two vectors, the direction at
           ``j pi / TIE_ANGLES`` (j = 0, 1, ...) whose order has the least
           connectivity cut over ``max(n_parts, 2)`` blocks of equal net
           weight, the first such j on a tie of cuts.

        The sign of the vector makes its largest entry positive (the
        first such entry on a tie)."""
        import scipy.sparse as sp
        from scipy.sparse.linalg import eigsh
        n = states.shape[0]
        lap = sp.csgraph.laplacian(g, normed=False).astype(np.float64)
        v0 = 1.0 + np.arange(n, dtype=np.float64) / n
        vals, vecs = eigsh(lap, k=min(FIEDLER_PAIRS, n - 1), sigma=-1e-3,
                           which="LM", v0=v0)
        keep = np.argsort(vals, kind="stable")
        vals, vecs = vals[keep], vecs[:, keep]
        # the smallest eigenvalue is 0 (constant vector); Fiedler's second
        tied = np.abs(vals - vals[1]) <= TIE_RTOL * abs(vals[1])
        tied[0] = False
        space = vecs[:, tied]
        if space.shape[1] == 1:
            return np.argsort(_signed(space[:, 0]), kind="stable")
        x = states.astype(np.float64)
        x = x - x.mean(axis=0)
        cand = np.concatenate([space @ (space.T @ x), space], axis=1)
        basis = []
        for v in cand.T:
            for e in basis:
                v = v - (e @ v) * e
            norm = np.linalg.norm(v)
            if norm > 1e-8 * np.sqrt(n):
                basis.append(v / norm)
            if len(basis) == 2:
                break
        nbrs = [state2index(states - stoich[r][None, :])
                for r in range(stoich.shape[0])]
        weights = StatePartitioner._net_weights(states, stoich, state2index)
        best = None
        for j in range(TIE_ANGLES):
            th = j * np.pi / TIE_ANGLES
            order = np.argsort(_signed(np.cos(th) * basis[0]
                                       + np.sin(th) * basis[1]),
                               kind="stable")
            cut = StatePartitioner._cuts(
                nbrs, order, StatePartitioner._weighted_blocks(
                    weights[order], max(n_parts, 2)))["connectivity_cut"]
            if best is None or cut < best[0]:
                best = (cut, order)
        return best[1]

    # ------------------------------------------------------------ metrics
    @staticmethod
    def partition_cuts(states, stoich, state2index, order,
                       boundaries) -> dict:
        """Cut metrics of a contiguous split of the given ordering:
        ``edge_cut`` = edges crossing a shard boundary (the GRAPH/ParMETIS
        objective) and ``connectivity_cut`` = sum over nets of (parts
        spanned - 1) (the HYPERGRAPH/PHG objective,
        StatePartitionerHyperGraph.cpp:90-104).  Used by the partitioner
        tests to compare strategies with the reference's own objectives.
        """
        nbrs = [state2index(states - stoich[r][None, :])
                for r in range(stoich.shape[0])]
        return StatePartitioner._cuts(nbrs, order, boundaries)

    @staticmethod
    def _cuts(nbrs, order, boundaries) -> dict:
        """:meth:`partition_cuts` from each reaction's in-neighbour
        indices ``nbrs[r]`` (-1 where absent)."""
        n = order.shape[0]
        pos = np.empty(n, dtype=np.int64)
        pos[order] = np.arange(n)               # state idx -> position
        part = np.searchsorted(np.asarray(boundaries), pos, side="right") - 1
        edge = 0
        nbr_parts = []                          # -1 = member absent
        for nbr in nbrs:
            ok = nbr >= 0
            pnbr = np.where(ok, part[np.where(ok, nbr, 0)], part)
            edge += int((pnbr != part).sum())
            nbr_parts.append(np.where(ok, pnbr, -1))
        # net(x) = {x} union in-neighbors; lambda = distinct parts touched
        nets = np.sort(np.stack([part] + nbr_parts, axis=1), axis=1)
        distinct = (nets[:, 1:] != nets[:, :-1]) & (nets[:, 1:] >= 0)
        lam = distinct.sum(axis=1) + (nets[:, 0] >= 0).astype(int)
        conn = int(np.maximum(lam - 1, 0).sum())
        return {"edge_cut": edge, "connectivity_cut": conn}

    @staticmethod
    def _weighted_blocks(weights: np.ndarray, n_parts: int) -> np.ndarray:
        """Contiguous boundaries balancing cumulative weight."""
        cw = np.concatenate([[0.0], np.cumsum(weights)])
        targets = cw[-1] * np.arange(n_parts + 1) / n_parts
        bounds = np.searchsorted(cw, targets)
        bounds[0], bounds[-1] = 0, weights.shape[0]
        return np.maximum.accumulate(bounds)


def _signed(v: np.ndarray) -> np.ndarray:
    """``v`` with the sign that makes its largest entry positive."""
    return -v if v[np.argmax(np.abs(v))] < 0 else v
