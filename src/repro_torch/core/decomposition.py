"""Matrix decomposition theorems underlying Cross Wiring (paper §3.4).

Theorem 3.1 (Symmetric Integer Matrix Decomposition): any symmetric integer
matrix ``C`` decomposes as ``C = A + Aᵀ`` with every row/col sum of ``A``
within ``⌊Σ/2⌋ .. ⌈Σ/2⌉`` of half the corresponding sum of ``C``.

Theorem 3.2 (Integer Matrix Decomposition, from Minimal Rewiring): any
integer matrix ``C`` splits into ``K`` integer matrices whose entries and
row/col sums are all within floor/ceil of ``1/K``-th of the originals.

The paper proves both via min-cost-flow (MCF) feasibility.  We implement the
MCF constructions (networkx) as *oracles* and two classical combinatorial
fast paths that are exact and near-linear:

* Thm 3.1 ≡ *balanced orientation* of the multigraph with adjacency ``C`` —
  Eulerian-circuit orientation with a dummy vertex absorbing odd degrees.
* the sub-permutation case of Thm 3.2 (the one MDMCF needs) ≡ *bipartite
  edge coloring* with ``Δ`` colors (König), via alternating-path recoloring —
  and it accepts a warm start, which is how MDMCF serves the Min-Rewiring
  objective (paper eq. 7).

All code is plain numpy + python — cluster control plane, not data plane.

The port's copy of the part of ``repro.core.decomposition`` that
:func:`~repro_torch.core.reconfig.mdmcf_reconfigure` reaches, with its
checks.  The general K-way split of Thm 3.2 (``halve_matrix``,
``integer_matrix_decompose*``) is not copied: nothing on the port's path
calls it.  :func:`symmetric_split_mcf` is the oracle and imports networkx
when called; the launcher's path (``method="euler"``) needs only numpy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "symmetric_split",
    "symmetric_split_euler",
    "symmetric_split_mcf",
    "assign_unit",
    "edge_color_bipartite",
    "check_symmetric_split",
    "check_edge_coloring",
]


# --------------------------------------------------------------------------
# Theorem 3.1 — fast path: Eulerian balanced orientation
# --------------------------------------------------------------------------

def _euler_orient(num_vertices: int, edges) -> np.ndarray:
    """Orient ``edges`` (undirected multigraph) so |out(v) - in(v)| <= 1.

    Classical construction: join all odd-degree vertices to a dummy vertex,
    walk Euler circuits (Hierholzer) orienting along the walk, drop dummy
    edges.  O(E).  Returns an ``(N, 2)`` int array of (tail, head) rows.
    The adjacency structure is built as a CSR incidence array with numpy
    (degrees via bincount, per-vertex slices via a stable argsort) so only
    the circuit walk itself remains a Python loop.
    """
    E0 = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    deg = np.bincount(E0.ravel(), minlength=num_vertices + 1)
    dummy = num_vertices
    odd = np.nonzero(deg[:num_vertices] % 2)[0]
    all_edges = np.concatenate(
        [E0, np.stack([np.full(odd.size, dummy, dtype=np.int64), odd], axis=1)]
    )
    M = all_edges.shape[0]
    if M == 0:
        return np.empty((0, 2), dtype=np.int64)

    # CSR incidence: per vertex, (edge_id, other_endpoint) in edge order —
    # stable sort of the interleaved endpoint list reproduces the classical
    # append-order adjacency exactly.
    verts = all_edges.ravel()
    eids = np.repeat(np.arange(M, dtype=np.int64), 2)
    others = all_edges[:, ::-1].ravel()
    order = np.argsort(verts, kind="stable")
    adj_eid = eids[order]
    adj_other = others[order]
    counts = np.bincount(verts, minlength=num_vertices + 1)
    indptr = np.zeros(num_vertices + 2, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    used = np.zeros(M, dtype=bool)
    ptr = indptr[:-1].copy()  # per-vertex scan pointer (amortized O(E))
    tails: List[int] = []
    eid_out: List[int] = []

    for start in range(num_vertices + 1):
        if ptr[start] >= indptr[start + 1]:
            continue
        # Hierholzer, iterative.  Record traversal direction of each edge.
        stack = [start]
        path_tails: List[int] = []
        path_eids: List[int] = []
        tail_stack: List[int] = []
        eid_stack: List[int] = []
        while stack:
            v = stack[-1]
            advanced = False
            while ptr[v] < indptr[v + 1]:
                eid = adj_eid[ptr[v]]
                w = adj_other[ptr[v]]
                ptr[v] += 1
                if used[eid]:
                    continue
                used[eid] = True
                stack.append(int(w))
                tail_stack.append(v)  # traversed v -> w
                eid_stack.append(int(eid))
                advanced = True
                break
            if not advanced:
                stack.pop()
                if eid_stack:
                    path_tails.append(tail_stack.pop())
                    path_eids.append(eid_stack.pop())
        tails.extend(path_tails)
        eid_out.extend(path_eids)

    t = np.asarray(tails, dtype=np.int64)
    e = np.asarray(eid_out, dtype=np.int64)
    u, v = all_edges[e, 0], all_edges[e, 1]
    h = np.where(t == u, v, u)
    keep = (t != dummy) & (h != dummy)
    return np.stack([t[keep], h[keep]], axis=1)


def symmetric_split_euler(C: np.ndarray) -> np.ndarray:
    """Thm 3.1 via Eulerian orientation.  Returns integer A with C = A + Aᵀ
    and balanced row/col sums.  Diagonal entries of C must be even."""
    C = np.asarray(C)
    if (C != C.T).any():
        raise ValueError("C must be symmetric")
    if (C < 0).any():
        raise ValueError("C must be non-negative")
    d = np.diagonal(C)
    if (d % 2).any():
        raise ValueError("diagonal entries of C must be even (C_ii = 2*A_ii)")
    P = C.shape[0]
    A = np.zeros_like(C)
    np.fill_diagonal(A, d // 2)
    # Pre-assign paired off-diagonal links symmetrically (a 2-cycle i->j->i is
    # already balanced); only the odd remainder needs orientation.
    off = C.copy()
    np.fill_diagonal(off, 0)
    half = off // 2
    A += half  # adds C_ij//2 in both directions
    rem = off - 2 * half  # 0/1 symmetric, zero diagonal
    iu, ju = np.nonzero(np.triu(rem, k=1))
    oriented = _euler_orient(P, np.stack([iu, ju], axis=1))
    np.add.at(A, (oriented[:, 0], oriented[:, 1]), 1)
    return A


# --------------------------------------------------------------------------
# Theorem 3.1 — oracle: the paper's MCF construction (networkx)
# --------------------------------------------------------------------------

def symmetric_split_mcf(C: np.ndarray) -> np.ndarray:
    """Thm 3.1 via the paper's min-cost-flow proof construction (DecomOPT).

    Used as a reference oracle in tests; the Euler path above is the
    production implementation.
    """
    import networkx as nx

    C = np.asarray(C)
    if (C != C.T).any():
        raise ValueError("C must be symmetric")
    d = np.diagonal(C)
    if (d % 2).any():
        raise ValueError("diagonal entries of C must be even")
    P = C.shape[0]
    A = np.zeros_like(C)
    np.fill_diagonal(A, d // 2)
    off = C.copy()
    np.fill_diagonal(off, 0)

    G = nx.DiGraph()
    demand: Dict[object, int] = {}
    rowsum = off.sum(axis=1)

    def add_demand(node, amt):
        demand[node] = demand.get(node, 0) + int(amt)

    total = 0
    for i in range(P):
        for j in range(i + 1, P):
            cij = int(off[i, j])
            if cij == 0:
                continue
            s = ("s", i, j)
            add_demand(s, -cij)  # supply
            total += cij
            G.add_edge(s, ("r", i), capacity=cij, weight=0)
            G.add_edge(s, ("r", j), capacity=cij, weight=0)
    t = "t"
    add_demand(t, total)
    # r_i -> t with bounds [floor(rowsum/2), ceil(rowsum/2)]
    for i in range(P):
        lo = int(rowsum[i]) // 2
        hi = -(-int(rowsum[i]) // 2)
        # lower-bound transformation: capacity hi-lo, shift demands by lo
        G.add_edge(("r", i), t, capacity=hi - lo, weight=0)
        add_demand(("r", i), lo)
        add_demand(t, -lo)
    for node, dem in demand.items():
        if node not in G:
            G.add_node(node)
        G.nodes[node]["demand"] = dem
    flow = nx.min_cost_flow(G)
    for i in range(P):
        for j in range(i + 1, P):
            if off[i, j] == 0:
                continue
            s = ("s", i, j)
            A[i, j] += flow[s].get(("r", i), 0)
            A[j, i] += flow[s].get(("r", j), 0)
    return A


def symmetric_split(C: np.ndarray, method: str = "euler") -> np.ndarray:
    if method == "euler":
        return symmetric_split_euler(C)
    if method == "mcf":
        return symmetric_split_mcf(C)
    raise ValueError(f"unknown method {method!r}")


def check_symmetric_split(C: np.ndarray, A: np.ndarray) -> None:
    """Assert the Thm 3.1 guarantees."""
    C = np.asarray(C)
    A = np.asarray(A)
    assert (A >= 0).all(), "A must be non-negative"
    assert (A + A.T == C).all(), "C != A + A^T"
    rs_c, cs_c = C.sum(axis=1), C.sum(axis=0)
    rs_a, cs_a = A.sum(axis=1), A.sum(axis=0)
    assert (rs_a >= rs_c // 2).all() and (rs_a <= -(-rs_c // 2)).all(), "row bound"
    assert (cs_a >= cs_c // 2).all() and (cs_a <= -(-cs_c // 2)).all(), "col bound"


# --------------------------------------------------------------------------
# Theorem 3.2 specialization — bipartite edge coloring (König)
# --------------------------------------------------------------------------

def assign_unit(
    rowc: np.ndarray,
    colc: np.ndarray,
    i: int,
    j: int,
    on_set=None,
    on_clear=None,
) -> int:
    """Color one directed unit ``(i, j)`` against a partial proper coloring.

    ``rowc[i, c]``/``colc[j, c]`` hold the matched column/row per color (or
    -1), with the number of colors given by their second axis.  Requires a
    free color at row ``i`` and at column ``j`` — the König precondition
    (fewer colored units at each endpoint than colors), under which a
    common free color exists or an (a, b)-alternating path inversion
    creates one.

    ``on_set(i, j, c)`` / ``on_clear(i, j, c)`` observe every (un)coloring,
    letting callers (e.g. the incremental MDMCF state) mirror the coloring
    into an OCS configuration.  Returns the number of path-flipped units.
    """
    free_i = rowc[i] == -1
    free_j = colc[j] == -1
    both = free_i & free_j
    if both.any():
        c = int(both.argmax())
        rowc[i, c] = j
        colc[j, c] = i
        if on_set is not None:
            on_set(i, j, c)
        return 0
    if not (free_i.any() and free_j.any()):
        raise ValueError("degree bound violated: no free color at an endpoint")
    a = int(free_i.argmax())  # first color free at row i
    b = int(free_j.argmax())  # first color free at col j
    # Invert the (a, b)-alternating path starting at column j (which is
    # missing color a).  The path cannot reach row i (parity argument), so
    # after inversion color a is free at both endpoints.
    path: List[Tuple[int, int, int]] = []  # (row, col, color)
    cur_color = a
    cur_node = j
    at_col = True
    while True:
        if at_col:
            r = int(colc[cur_node, cur_color])
            if r == -1:
                break
            path.append((r, cur_node, cur_color))
            cur_node, at_col = r, False
            cur_color = b if cur_color == a else a
        else:
            cc = int(rowc[cur_node, cur_color])
            if cc == -1:
                break
            path.append((cur_node, cc, cur_color))
            cur_node, at_col = cc, True
            cur_color = b if cur_color == a else a
    for (r, cc, col_) in path:
        rowc[r, col_] = -1
        colc[cc, col_] = -1
        if on_clear is not None:
            on_clear(r, cc, col_)
    for (r, cc, col_) in path:
        other = b if col_ == a else a
        rowc[r, other] = cc
        colc[cc, other] = r
        if on_set is not None:
            on_set(r, cc, other)
    assert rowc[i, a] == -1 and colc[j, a] == -1
    rowc[i, a] = j
    colc[j, a] = i
    if on_set is not None:
        on_set(i, j, a)
    return len(path)


def edge_color_bipartite(
    A: np.ndarray,
    num_colors: int,
    warm: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Decompose non-negative integer matrix ``A`` (row & col sums ≤
    ``num_colors``) into ``num_colors`` sub-permutation 0/1 matrices.

    Returns ``colors`` of shape ``(num_colors, P, Q)`` with
    ``colors.sum(0) == A`` and each slice having row/col sums ≤ 1.

    ``warm`` (optional, same shape as the output) seeds the coloring with a
    previous configuration: any unit of demand that the old configuration
    already carried keeps its color when still free — this implements the
    Min-Rewiring objective (paper eq. 7) inside the decomposition.

    Algorithm: classical alternating-path bipartite edge coloring
    (König / Vizing restricted to bipartite), O(E · (P + num_colors)).
    The bulk of the units carry a color free at both endpoints and is
    assigned in vectorized conflict-free waves; only the leftovers walk
    the scalar alternating-path machinery (:func:`assign_unit`).
    """
    A = np.asarray(A)
    if (A < 0).any():
        raise ValueError("A must be non-negative")
    P, Q = A.shape
    K = num_colors
    if (A.sum(axis=1) > K).any() or (A.sum(axis=0) > K).any():
        raise ValueError("row/col sums must be <= num_colors")

    # rowc[i, c] = matched column (or -1); colc[j, c] = matched row (or -1)
    rowc = np.full((P, K), -1, dtype=np.int64)
    colc = np.full((Q, K), -1, dtype=np.int64)
    remaining = A.astype(np.int64).copy()

    # ---- warm start ------------------------------------------------------
    if warm is not None:
        warm = np.asarray(warm)
        if warm.shape != (K, P, Q):
            raise ValueError("warm must have shape (num_colors, P, Q)")
        cs, is_, js = np.nonzero(warm)
        for c, i, j in zip(cs.tolist(), is_.tolist(), js.tolist()):
            if remaining[i, j] > 0 and rowc[i, c] == -1 and colc[j, c] == -1:
                rowc[i, c] = j
                colc[j, c] = i
                remaining[i, j] -= 1

    # ---- wave phase: batch-assign units with a common free color ---------
    iu, ju = np.nonzero(remaining)
    counts = remaining[iu, ju]
    ui = np.repeat(iu, counts)
    uj = np.repeat(ju, counts)
    while ui.size:
        common = (rowc[ui] == -1) & (colc[uj] == -1)  # (U, K)
        has = common.any(axis=1)
        if not has.any():
            break
        hi, hj = ui[has], uj[has]
        pick = common[has].argmax(axis=1)  # first common free color
        U = hi.size
        idx = np.arange(U)
        # conflict-free subset: keep only the first unit per (row, color)
        # and per (col, color) slot, exactly what sequential order would do
        kic = hi * K + pick
        kjc = hj * K + pick
        first_ic = np.full(P * K, U, dtype=np.int64)
        first_jc = np.full(Q * K, U, dtype=np.int64)
        np.minimum.at(first_ic, kic, idx)
        np.minimum.at(first_jc, kjc, idx)
        win = (first_ic[kic] == idx) & (first_jc[kjc] == idx)
        rowc[hi[win], pick[win]] = hj[win]
        colc[hj[win], pick[win]] = hi[win]
        keep = np.ones(ui.size, dtype=bool)
        keep[np.nonzero(has)[0][win]] = False
        ui, uj = ui[keep], uj[keep]

    # ---- leftovers: alternating-path recoloring --------------------------
    for i, j in zip(ui.tolist(), uj.tolist()):
        assign_unit(rowc, colc, i, j)

    colors = np.zeros((K, P, Q), dtype=np.int8)
    for c in range(K):
        rows = np.nonzero(rowc[:, c] >= 0)[0]
        colors[c, rows, rowc[rows, c]] = 1
    return colors


def check_edge_coloring(A: np.ndarray, colors: np.ndarray) -> None:
    assert (colors.sum(axis=0) == A).all(), "colors do not sum to A"
    assert (colors.sum(axis=2) <= 1).all(), "row sum > 1 in a color class"
    assert (colors.sum(axis=1) <= 1).all(), "col sum > 1 in a color class"
