"""Exact MWIS solvers — the native C++ branch & bound and its provers.

The port's own copy of `distgcn_tpu/solvers/exact.py`. API parity with the
reference's `mlp_gurobi` (heuristics.py:327-355):
``mwis_exact(adj, wts, timeout) -> (solution_indices, utility, status)``
with status in {"Optimal", "Timeout"}.

The native solver is the port's own copy of the source,
`distgcn_tpu_torch/native/mwis_exact.cpp`. At first use it is compiled with
``g++ -O3 -march=native`` into `BUILD_DIR`, ``build/native/`` at the
repository root (gitignored) unless `utils.compile_cache` places it
elsewhere; the library's file name carries a hash of the source, the
flags and the instruction set that ``-march=native`` resolves to, so an
edited source or another host's CPU gets a library of its own. It is built
under a private name and renamed into place, so a process that already
loaded a library never sees it truncated. There is no silent fallback:
`_load_native` raises if the library cannot be built or loaded.
`_python_bnb` is the set-based B&B of the same algorithm, kept as an
independent reference for tests.

It also exports fast host greedy/LGS used by the wireless simulator's
CPU-bound loops (`fast_greedy`, `fast_local_greedy`), the HiGHS MILP
cross-check (`mwis_milp`), the root cutting-plane LP with its dual
certificate (`mwis_root_duals`, `mwis_exact_dual`), the proving portfolio
(`mwis_prove`) and the cutting-plane MILP (`mwis_cut`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from distgcn_tpu_torch.solvers.greedy import greedy_search
from distgcn_tpu_torch.utils.compile_cache import REPO_BUILD

SRC = Path(__file__).resolve().parent.parent / "native" / "mwis_exact.cpp"
BUILD_DIR = REPO_BUILD / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_F64P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "mwis_exact": (ctypes.c_int, [_I32P, _I32P, _F64P, ctypes.c_int,
                                  ctypes.c_double, _I8P, _F64P]),
    "mwis_exact_ws": (ctypes.c_int, [_I32P, _I32P, _F64P, ctypes.c_int,
                                     ctypes.c_double, _I8P, _I8P, _F64P]),
    "mwis_exact_dual": (ctypes.c_int, [_I32P, _I32P, _F64P, ctypes.c_int,
                                       ctypes.c_double, _I8P, _I32P, _I32P,
                                       _F64P, _F64P, ctypes.c_int, _I8P,
                                       _F64P]),
    "greedy_mwis": (ctypes.c_double, [_I32P, _I32P, _F64P, ctypes.c_int,
                                      _I8P]),
    "local_greedy": (ctypes.c_int, [_I32P, _I32P, _F64P, ctypes.c_int, _I8P,
                                    _F64P]),
}


def _native_target() -> bytes:
    """The flags ``-march=native`` expands to on this host (g++'s cc1
    command line), so a library built for one CPU is never loaded on
    another."""
    out = subprocess.run(["g++", "-march=native", "-E", "-v", "-"],
                         input="", capture_output=True, text=True,
                         timeout=60)
    lines = [ln for ln in out.stderr.splitlines() if "cc1" in ln]
    if out.returncode != 0 or not lines:
        raise RuntimeError("g++ could not resolve -march=native:\n"
                           + out.stderr)
    return lines[0].split(" - ", 1)[-1].encode()


def library_path() -> Path:
    """Where the native library for this source, flags and host lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _native_target())
    return BUILD_DIR / f"libmwis_exact-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the native solver if this host has no current library;
    returns its path. Raises with g++'s output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {SRC} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_native() -> ctypes.CDLL:
    """The native solver library (built at first use), with its ctypes
    signatures set. Raises RuntimeError if it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def native_library() -> str:
    """The path of the loaded native library."""
    return _load_native()._name


def _csr(adj) -> sp.csr_matrix:
    a = adj.tocsr() if sp.issparse(adj) else sp.csr_matrix(np.asarray(adj))
    return a.astype(np.float64)


def _csr_ptrs(a: sp.csr_matrix):
    indptr = np.ascontiguousarray(a.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(a.indices, dtype=np.int32)
    return (indptr, indices, indptr.ctypes.data_as(_I32P),
            indices.ctypes.data_as(_I32P))


def _weights(wts) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(wts, dtype=np.float64).flatten())


def mwis_exact(adj, wts, timeout: float = 300.0, init_sel=None
               ) -> Tuple[np.ndarray, float, str]:
    """Exact MWIS. Returns (selected indices, utility, status).

    init_sel: optional 0/1 warm-start independent set (e.g. the best
    feasible point another portfolio arm found) — seeds the native B&B's
    incumbent per subproblem."""
    lib = _load_native()
    a = _csr(adj)
    w = _weights(wts)
    n = w.size
    _, _, p_indptr, p_indices = _csr_ptrs(a)
    sel = np.zeros(n, dtype=np.int8)
    val = ctypes.c_double(0.0)
    if init_sel is not None:
        init = np.ascontiguousarray(np.asarray(init_sel, np.int8).flatten())
        assert init.size == n, (init.size, n)
        status = lib.mwis_exact_ws(
            p_indptr, p_indices, w.ctypes.data_as(_F64P), n,
            ctypes.c_double(timeout), init.ctypes.data_as(_I8P),
            sel.ctypes.data_as(_I8P), ctypes.byref(val))
    else:
        status = lib.mwis_exact(
            p_indptr, p_indices, w.ctypes.data_as(_F64P), n,
            ctypes.c_double(timeout), sel.ctypes.data_as(_I8P),
            ctypes.byref(val))
    solu = np.nonzero(sel == 1)[0]
    return solu, float(val.value), "Optimal" if status == 0 else "Timeout"


# alias matching the reference's name, so ported callers read naturally
mlp_gurobi = mwis_exact


def fast_greedy(adj, wts) -> Tuple[set, float]:
    """Native `greedy_search` (heuristics.py:13-35)."""
    lib = _load_native()
    a = _csr(adj)
    w = _weights(wts)
    _, _, p_indptr, p_indices = _csr_ptrs(a)
    sel = np.zeros(w.size, dtype=np.int8)
    val = lib.greedy_mwis(p_indptr, p_indices, w.ctypes.data_as(_F64P),
                          w.size, sel.ctypes.data_as(_I8P))
    return set(np.nonzero(sel == 1)[0].tolist()), float(val)


def fast_local_greedy(adj, wts) -> Tuple[set, float]:
    """Native `local_greedy_search` (heuristics.py:77-116)."""
    lib = _load_native()
    a = _csr(adj)
    w = _weights(wts)
    _, _, p_indptr, p_indices = _csr_ptrs(a)
    sel = np.zeros(w.size, dtype=np.int8)
    val = ctypes.c_double(0.0)
    lib.local_greedy(p_indptr, p_indices, w.ctypes.data_as(_F64P), w.size,
                     sel.ctypes.data_as(_I8P), ctypes.byref(val))
    return set(np.nonzero(sel == 1)[0].tolist()), float(val.value)


def _python_bnb(a: sp.csr_matrix, w: np.ndarray, timeout: float
                ) -> Tuple[np.ndarray, float, str]:
    """Set-based B&B (greedy seed, positive-weight bound, branch on the
    max-degree candidate): an independent reference for the native one."""
    n = w.size
    deadline = time.monotonic() + timeout
    nbrs = [frozenset(a.indices[a.indptr[v]: a.indptr[v + 1]].tolist())
            for v in range(n)]
    seed, seed_val = greedy_search(a, w)
    best = [seed_val - 1e-12, set(seed)]
    timed_out = [False]

    def ub(P):
        return sum(w[v] for v in P if w[v] > 0)

    def rec(P: set, cur: float, sel: set):
        if timed_out[0]:
            return
        if time.monotonic() > deadline:
            timed_out[0] = True
            return
        if not P:
            if cur > best[0]:
                best[0], best[1] = cur, set(sel)
            return
        if cur + ub(P) <= best[0]:
            return
        v = max(P, key=lambda u: (len(nbrs[u] & P), w[u]))
        rec(P - nbrs[v] - {v}, cur + w[v], sel | {v})   # include
        rec(P - {v}, cur, sel)                          # exclude

    rec(set(range(n)), 0.0, set())
    solu = np.array(sorted(best[1]), dtype=int)
    return solu, float(w[solu].sum() if solu.size else 0.0), \
        "Timeout" if timed_out[0] else "Optimal"


def all_maximal_is(adj) -> list:
    """Enumerate ALL maximal independent sets (reference `get_all_mis`,
    heuristics.py:308-318). Bron-Kerbosch with pivoting on the complement
    graph (maximal IS of G == maximal cliques of G-complement).
    Exponential in the worst case — intended for small label-generation
    graphs. Returns a list of sorted node-id lists."""
    a = _csr(adj)
    n = a.shape[0]
    nbrs = [set(a.indices[a.indptr[v]: a.indptr[v + 1]].tolist()) - {v}
            for v in range(n)]
    allv = set(range(n))
    co = [allv - nbrs[v] - {v} for v in range(n)]
    out = []

    def bk(r: set, p: set, x: set):
        if not p and not x:
            out.append(sorted(r))
            return
        pivot = max(p | x, key=lambda u: len(co[u] & p))
        for v in list(p - co[pivot]):
            bk(r | {v}, p & co[v], x & co[v])
            p.discard(v)
            x.add(v)

    bk(set(), set(range(n)), set())
    return out


def get_mwis(adj, wts) -> Tuple[set, float]:
    """Best maximal IS by total weight via exhaustive enumeration
    (reference `get_mwis`, heuristics.py:320-324)."""
    w = np.asarray(wts, dtype=float).flatten()
    best, best_val = set(), -np.inf
    for mis in all_maximal_is(adj):
        val = float(w[mis].sum())
        if val > best_val:
            best, best_val = set(mis), val
    return best, best_val


def mwis_milp(adj, wts, time_limit: float = 300.0
              ) -> Tuple[np.ndarray, float, str]:
    """Exact MWIS via an independent MIP engine (HiGHS through
    scipy.optimize.milp, edge formulation x_u + x_v <= 1): a second,
    algorithmically unrelated prover to cross-validate the native B&B.
    Returns (0/1 selection, utility, status)."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    a = sp.csr_matrix(adj)
    w = np.asarray(wts, dtype=np.float64).flatten()
    n = w.size
    coo = sp.triu(a, 1).tocoo()
    if coo.nnz == 0:
        sel = (w > 0).astype(np.int8)
        return sel, float(w[w > 0].sum()), "Optimal"
    pairs = np.column_stack([coo.row, coo.col]).ravel()
    A = sp.coo_matrix((np.ones(coo.nnz * 2),
                       (np.repeat(np.arange(coo.nnz), 2), pairs)),
                      shape=(coo.nnz, n))
    res = milp(c=-w, constraints=LinearConstraint(A, -np.inf, 1),
               bounds=Bounds(0, 1), integrality=np.ones(n),
               options={"time_limit": float(time_limit)})
    if res.x is None:
        return np.zeros(n, np.int8), 0.0, _milp_status(res.status)
    sel = (res.x > 0.5).astype(np.int8)
    return sel, float(w[sel == 1].sum()), _milp_status(res.status)


def _milp_status(code: int) -> str:
    """scipy.optimize.milp status codes: 0 proven optimal, 1 time/iteration
    limit, everything else (infeasible=2, unbounded=3, numerical failure=4)
    a genuine solver failure that resumable sweeps must not retry."""
    return {0: "Optimal", 1: "Timeout"}.get(int(code), f"Failed({code})")


def _separate_odd_cycles(adj_csr, x, n_cuts: int = 300):
    """Violated odd-cycle inequalities sum_{v in C} x_v <= (|C|-1)/2 for
    the LP point x (Grötschel-Lovász-Schrijver separation): edge slack
    z_uv = 1 - x_u - x_v >= 0, shortest u0 -> u1 paths of total slack < 1
    in the bipartite double cover (scipy.sparse.csgraph.dijkstra). Returns
    a list of vertex-index lists (each an odd simple cycle)."""
    from scipy.sparse.csgraph import dijkstra

    n = adj_csr.shape[0]
    coo = sp.triu(adj_csr, 1).tocoo()
    z = np.maximum(1.0 - x[coo.row] - x[coo.col], 1e-12)
    zmat = sp.coo_matrix((z, (coo.row, coo.col)), shape=(n, n))
    zmat = zmat + zmat.T
    dc = sp.bmat([[None, zmat], [zmat, None]], format="csr")
    dist, pred = dijkstra(dc, indices=np.arange(n), limit=1.0,
                          return_predecessors=True)
    viol = dist[np.arange(n), np.arange(n) + n]
    order = np.argsort(viol)
    cuts, seen = [], set()
    for s in order:
        if viol[s] >= 1.0 - 1e-7:
            break
        path, cur = [], s + n           # walk back s+n -> s
        while cur != s and cur >= 0:
            path.append(cur % n)
            cur = pred[s, cur]
        if cur < 0:
            continue
        if len(path) % 2 == 0:          # an odd cycle has odd vertex count
            continue
        key = tuple(sorted(set(path)))
        if len(key) != len(path) or key in seen:   # non-simple walk
            continue
        seen.add(key)
        cuts.append(list(key))
        if len(cuts) >= n_cuts:
            break
    return cuts


def _base_clique_rows(coo, n):
    """Greedy edge clique cover rows (they dominate raw edge rows).
    Returns (rows_i, rhs): lists of [m, L] index blocks and rhs vectors."""
    rows_i, rhs = [], []
    if n <= 4096:
        dense = np.zeros((n, n), dtype=bool)
        dense[coo.row, coo.col] = True
        dense |= dense.T
        covered = np.zeros_like(dense)
        bylen = {}
        for u, v in zip(coo.row, coo.col):
            if covered[u, v]:
                continue
            mem = [u, v]
            common = dense[u] & dense[v]
            while common.any():
                x = int(np.argmax(common))
                mem.append(x)
                common &= dense[x]
            mi = np.asarray(mem)
            covered[np.ix_(mi, mi)] = True
            bylen.setdefault(len(mem), []).append(mem)
        for cs in bylen.values():
            rows_i.append(np.asarray(cs, dtype=np.int64))
            rhs.append(np.ones(len(cs)))
    else:
        rows_i = [np.column_stack([coo.row, coo.col])]
        rhs = [np.ones(coo.nnz)]
    return rows_i, rhs


def _row_matrix(rows_i, n) -> sp.coo_matrix:
    """The constraint matrix of a list of [m, L] index blocks."""
    ri, ci = [], []
    off = 0
    for blk in rows_i:
        m, k = blk.shape
        ri.append(np.repeat(np.arange(off, off + m), k))
        ci.append(blk.ravel())
        off += m
    return sp.coo_matrix((np.ones(sum(len(r) for r in ri)),
                          (np.concatenate(ri), np.concatenate(ci))),
                         shape=(off, n))


def _add_cuts(rows_i, rhs, cuts) -> None:
    """Append odd-cycle cuts, grouped by length into dense blocks."""
    bylen = {}
    for c in cuts:
        bylen.setdefault(len(c), []).append(c)
    for L, cs in bylen.items():
        rows_i.append(np.asarray(cs, dtype=np.int64))
        rhs.append(np.full(len(cs), (L - 1) / 2.0))


def mwis_root_duals(adj, wts, time_budget: float = 60.0,
                    max_sep_rounds: int = 40):
    """Root cutting-plane LP (clique rows + odd-cycle cuts) solved to
    optimality, returning its DUAL certificate as a static bound pool for
    the native B&B (`mwis_exact_dual`).

    Produces (con_ptr, con_idx, y, rhs, ub_root, rc) where constraint j is
    the vertex set con_idx[con_ptr[j]:con_ptr[j+1]] with dual weight y[j]>0
    and capacity rhs[j], satisfying cover(v) := sum_{j: v in C_j} y_j >= w_v
    for every v (tolerance-level slack repaired by singleton rows). So
    w(S) <= sum_j y_j * min(rhs_j, |C_j ∩ P|) for any IS S inside P;
    ub_root = sum_j y_j * rhs_j is a proven upper bound; rc[v] =
    cover(v) - w_v >= 0 is a reduced cost. Returns None if the LP fails.
    """
    from scipy.optimize import linprog

    a = _csr(adj)
    w = np.asarray(wts, dtype=np.float64).flatten()
    n = w.size
    coo = sp.triu(a, 1).tocoo()
    t0 = time.time()
    rows_i, rhs = _base_clique_rows(coo, n)
    res = None
    ub_prev = np.inf
    n_blocks_solved = len(rows_i)
    for _ in range(max_sep_rounds):
        res = linprog(-w, A_ub=_row_matrix(rows_i, n),
                      b_ub=np.concatenate(rhs), bounds=(0, 1),
                      method="highs")
        if res.x is None:
            return None
        n_blocks_solved = len(rows_i)
        ub = -res.fun
        if time.time() - t0 > time_budget:
            break
        cuts = _separate_odd_cycles(a, res.x)
        if not cuts:
            break
        _add_cuts(rows_i, rhs, cuts)
        if ub > ub_prev - 1e-5:   # separation stalled
            ub_prev = min(ub, ub_prev)
            res2 = linprog(-w, A_ub=_row_matrix(rows_i, n),
                           b_ub=np.concatenate(rhs), bounds=(0, 1),
                           method="highs")
            if res2.x is not None:
                res = res2
                n_blocks_solved = len(rows_i)
            break
        ub_prev = min(ub, ub_prev)
    # the dual certificate must match the rows `res` actually solved
    rows_i = rows_i[:n_blocks_solved]
    rhs = rhs[:n_blocks_solved]

    y_rows = np.maximum(-np.asarray(res.ineqlin.marginals), 0.0)
    y_upper = np.maximum(-np.asarray(res.upper.marginals), 0.0)
    cons_idx, cons_y, cons_rhs = [], [], []
    off = 0
    all_rhs = np.concatenate(rhs)
    for blk in rows_i:
        m, _ = blk.shape
        for i in range(m):
            yj = y_rows[off + i]
            if yj > 1e-9:
                cons_idx.append(blk[i])
                cons_y.append(yj)
                cons_rhs.append(all_rhs[off + i])
        off += m
    # x_v <= 1 bound duals enter as singleton rows
    for v in np.nonzero(y_upper > 1e-9)[0]:
        cons_idx.append(np.asarray([v]))
        cons_y.append(float(y_upper[v]))
        cons_rhs.append(1.0)
    # repair tolerance-level dual infeasibility: cover(v) >= w_v exactly
    cover = np.zeros(n)
    for idx, yj in zip(cons_idx, cons_y):
        cover[idx] += yj
    slack = cover - w
    for v in np.nonzero(slack < 0)[0]:
        pad = -slack[v] + 1e-12
        cons_idx.append(np.asarray([v]))
        cons_y.append(float(pad))
        cons_rhs.append(1.0)
        cover[v] += pad
    rc = cover - w
    y = np.asarray(cons_y)
    rhs_v = np.asarray(cons_rhs)
    ub_root = float(np.dot(y, rhs_v))
    con_ptr = np.zeros(len(cons_idx) + 1, np.int32)
    con_ptr[1:] = np.cumsum([len(c) for c in cons_idx])
    con_idx = (np.concatenate(cons_idx).astype(np.int32)
               if cons_idx else np.zeros(0, np.int32))
    return (con_ptr, con_idx, y, rhs_v, ub_root, rc)


def mwis_exact_dual(adj, wts, timeout: float, cons, init_sel=None
                    ) -> Tuple[np.ndarray, float, str]:
    """Native B&B with the static root-LP dual bound pool (`mwis_root_duals`
    output); plain `mwis_exact` when there is no pool."""
    if cons is None:
        return mwis_exact(adj, wts, timeout, init_sel=init_sel)
    lib = _load_native()
    a = _csr(adj)
    w = _weights(wts)
    n = w.size
    con_ptr, con_idx, y, rhs_v, _, _ = cons
    con_ptr = np.ascontiguousarray(con_ptr, np.int32)
    con_idx = np.ascontiguousarray(con_idx, np.int32)
    y = np.ascontiguousarray(y, np.float64)
    rhs_v = np.ascontiguousarray(rhs_v, np.float64)
    _, _, p_indptr, p_indices = _csr_ptrs(a)
    sel = np.zeros(n, dtype=np.int8)
    val = ctypes.c_double(0.0)
    p_init = None
    if init_sel is not None:
        init = np.ascontiguousarray(np.asarray(init_sel, np.int8).flatten())
        p_init = init.ctypes.data_as(_I8P)
    status = lib.mwis_exact_dual(
        p_indptr, p_indices, w.ctypes.data_as(_F64P), n,
        ctypes.c_double(timeout), p_init, con_ptr.ctypes.data_as(_I32P),
        con_idx.ctypes.data_as(_I32P), y.ctypes.data_as(_F64P),
        rhs_v.ctypes.data_as(_F64P), len(y), sel.ctypes.data_as(_I8P),
        ctypes.byref(val))
    solu = np.nonzero(sel == 1)[0]
    return solu, float(val.value), "Optimal" if status == 0 else "Timeout"


def mwis_prove(adj, wts, timeout: float = 300.0,
               verbose: bool = False) -> Tuple[np.ndarray, float, str]:
    """The proving portfolio — the `--solver=auto` path of
    `cli/benchmark_solver` (reference protocol mwis_mlp_test.py:79-152,
    with Gurobi replaced by native machinery):

      1. a short native B&B pass (closes easy instances; its incumbent is
         kept either way);
      2. with a budget of at least 600 s: the HiGHS MILP (`mwis_milp`) on
         the remaining budget;
      3. otherwise the root cutting-plane LP (`mwis_root_duals`): if its
         upper bound meets the incumbent, optimality is certified;
      4. reduced-cost fixing of every vertex the LP bound excludes;
      5. the native B&B over the residue, warm-started, pruning with the
         static dual pool at every node.
    """
    a = _csr(adj)
    w = np.asarray(wts, dtype=np.float64).flatten()
    n = w.size
    t0 = time.time()
    t_bnb = min(timeout * 0.12, 30.0)
    sel1, util, status = mwis_exact(a, w, t_bnb)
    if status == "Optimal":
        return sel1, util, status
    if timeout >= 600.0:
        remain = max(timeout - (time.time() - t0), 1.0)
        sel_m, util_m, st_m = mwis_milp(a, w, remain)   # 0/1 vector
        if verbose:
            print(f"[prove] milp arm: util={util_m:.6f} {st_m} "
                  f"t={time.time() - t0:.1f}s", flush=True)
        if st_m == "Optimal" and util_m >= util - 1e-9:
            return np.nonzero(sel_m)[0], util_m, st_m
        # keep the better primal and go on to stages 3-5 with what is left
        if util_m > util:
            util = util_m
            sel1 = np.nonzero(sel_m)[0]
        if timeout - (time.time() - t0) < 30.0:
            return sel1, util, "Timeout"
    best_sel = np.zeros(n, np.int8)
    best_sel[np.asarray(sel1, np.int64)] = 1
    # stages 3-5 honour the caller's total budget: plan from the remainder
    remain0 = max(timeout - (time.time() - t0), 1.0)
    cons = mwis_root_duals(a, w,
                           time_budget=min(remain0 * 0.5, timeout * 0.15,
                                           60.0)) \
        if timeout >= 120 else None
    if cons is None:
        remain = max(timeout - (time.time() - t0), 1.0)
        return mwis_exact(a, w, remain, init_sel=best_sel)
    ub_root = cons[4]
    if verbose:
        print(f"[prove] incumbent {util:.6f} ub_root {ub_root:.6f} "
              f"cons {len(cons[2])} t={time.time() - t0:.1f}s", flush=True)
    if ub_root <= util + 1e-6:
        return np.nonzero(best_sel)[0], util, "Optimal"
    remain = max(timeout - (time.time() - t0), 1.0)
    if (ub_root - util) > 0.08 * max(util, 1e-9):
        # with a root gap this large the static pool never prunes and
        # rc-fixing removes nothing: keep only the warm start
        return mwis_exact(a, w, remain, init_sel=best_sel)
    # reduced-cost fixing (conservative margin): any IS containing v is
    # bounded by ub_root - rc[v]; below the incumbent it cannot matter
    rc = cons[5]
    w_fix = w.copy()
    fixed = (ub_root - rc) < (util - 1e-7)
    w_fix[fixed] = -1.0
    if verbose and fixed.any():
        print(f"[prove] rc-fixed {int(fixed.sum())}/{n} vertices", flush=True)
    sel2, util2, status = mwis_exact_dual(a, w_fix, remain, cons,
                                          init_sel=best_sel * (1 - fixed))
    if util2 >= util:
        return sel2, util2, status
    return np.nonzero(best_sel)[0], util, status


def mwis_cut(adj, wts, time_limit: float = 300.0,
             incumbent: float | None = None,
             max_sep_rounds: int = 40,
             sep_budget_frac: float = 0.35
             ) -> Tuple[np.ndarray, float, str]:
    """Exact MWIS via root cutting planes + HiGHS MILP: a separation loop
    (LP over clique rows, violated odd-cycle cuts added until the bound
    stalls or `sep_budget_frac` of the budget is spent), then the
    strengthened formulation to HiGHS MILP, with ``w.x >= incumbent`` as a
    row when an incumbent is given. Same return contract as `mwis_milp`."""
    from scipy.optimize import Bounds, LinearConstraint, linprog, milp

    a = _csr(adj)
    w = np.asarray(wts, dtype=np.float64).flatten()
    n = w.size
    coo = sp.triu(a, 1).tocoo()
    if coo.nnz == 0:
        sel = (w > 0).astype(np.int8)
        return sel, float(w[w > 0].sum()), "Optimal"
    t0 = time.time()
    rows_i, rhs = _base_clique_rows(coo, n)
    for _ in range(max_sep_rounds):
        if time.time() - t0 > sep_budget_frac * time_limit:
            break
        res = linprog(-w, A_ub=_row_matrix(rows_i, n),
                      b_ub=np.concatenate(rhs), bounds=(0, 1),
                      method="highs")
        if res.x is None:
            break
        cuts = _separate_odd_cycles(a, res.x)
        if not cuts:
            break
        _add_cuts(rows_i, rhs, cuts)
    cons = [LinearConstraint(_row_matrix(rows_i, n), -np.inf,
                             np.concatenate(rhs))]
    if incumbent is not None and incumbent > 0:
        cons.append(LinearConstraint(sp.csr_matrix(w), incumbent - 1e-7,
                                     np.inf))
    remain = max(time_limit - (time.time() - t0), 5.0)
    res = milp(c=-w, constraints=cons, bounds=Bounds(0, 1),
               integrality=np.ones(n), options={"time_limit": float(remain)})
    if res.x is None:  # timed out before any feasible point
        return np.zeros(n, np.int8), float(incumbent or 0.0), \
            _milp_status(res.status)
    sel = (res.x > 0.5).astype(np.int8)
    return sel, float(w[sel == 1].sum()), _milp_status(res.status)
