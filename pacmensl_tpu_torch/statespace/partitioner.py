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
  fails.
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
                    objective="connectivity" if hyper else "bandwidth")
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
                        objective: str = "bandwidth") -> np.ndarray:
        """Ordering of the CME dependency graph so a contiguous 1-D split
        has a small boundary cut.

        ``bandwidth`` (GRAPH): reverse-Cuthill-McKee.
        ``connectivity`` (HYPERGRAPH): Fiedler-vector (spectral) order —
        minimizes sum_edges (pos_i - pos_j)^2, the continuous relaxation
        of the PHG connectivity-cut objective; falls back to RCM when the
        eigensolve fails or scipy is unavailable.
        """
        n = states.shape[0]
        if state2index is None:
            return np.arange(n)
        g = StatePartitioner._adjacency(states, stoich, state2index)
        if g is None:
            return np.arange(n)
        if objective == "connectivity" and n > 2:
            try:
                import scipy.sparse as sp
                from scipy.sparse.linalg import eigsh
                lap = sp.csgraph.laplacian(g, normed=False)
                # smallest two eigenpairs; Fiedler = second
                _, vecs = eigsh(lap.astype(np.float64), k=2, sigma=-1e-3,
                                which="LM")
                fiedler = vecs[:, 1]
                return np.argsort(fiedler, kind="stable").astype(np.int64)
            except Exception:
                pass                      # spectral failed: RCM fallback
        try:
            from scipy.sparse.csgraph import reverse_cuthill_mckee
        except ImportError:          # host-side dependency only; fallback
            return np.arange(n)
        perm = reverse_cuthill_mckee(g, symmetric_mode=True)
        return np.asarray(perm, dtype=np.int64)

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
        n, m = states.shape[0], stoich.shape[0]
        pos = np.empty(n, dtype=np.int64)
        pos[order] = np.arange(n)               # state idx -> position
        part = np.searchsorted(np.asarray(boundaries), pos, side="right") - 1
        edge = 0
        nbr_parts = []                          # -1 = member absent
        for r in range(m):
            nbr = state2index(states - stoich[r][None, :])
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
