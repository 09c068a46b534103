"""Build-once cache of the screened-Poisson hierarchy operators
A = M - 0.01 L of an icosphere order (SSP prolongations + Galerkin
coarse operators): <checkout>/.ops_cache/ico{order}/{A<l>,P<l>}.npz, so
repeated benchmark runs skip the host hierarchy build.

Usage: python benchmarks/ico_ops_cache.py [order=7]
"""
import os
import sys
import time

import scipy.sparse as sp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ops_dir(order: int) -> str:
    return os.path.join(ROOT, ".ops_cache", f"ico{order}")


def load_ops(order: int):
    """(As, Ps) lists of csr matrices, building the cache if absent."""
    d = ops_dir(order)
    if not os.path.isdir(d):
        build_cache(order)
    As, Ps = [], []
    lv = 0
    while os.path.exists(f"{d}/A{lv}.npz"):
        As.append(sp.load_npz(f"{d}/A{lv}.npz").tocsr())
        lv += 1
    lv = 0
    while os.path.exists(f"{d}/P{lv}.npz"):
        Ps.append(sp.load_npz(f"{d}/P{lv}.npz").tocsr())
        lv += 1
    return As, Ps


def build_cache(order: int):
    sys.path.insert(0, ROOT)
    from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
    from surface_multigrid_code_tpu.utils.synthetic import icosphere

    t0 = time.time()
    V, F = icosphere(order)
    mg = mg_precompute(V, F, verbose=False)
    A = (massmatrix(V, F) - 0.01 * cotmatrix(V, F)).tocsr()
    As = [A]
    Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    d = ops_dir(order)
    os.makedirs(d, exist_ok=True)
    for lv, M in enumerate(As):
        sp.save_npz(f"{d}/A{lv}.npz", M.tocsr())
    for lv, M in enumerate(Ps):
        sp.save_npz(f"{d}/P{lv}.npz", M.tocsr())
    print(f"cached icosphere({order}) ops in {d} "
          f"({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)


if __name__ == "__main__":
    build_cache(int(sys.argv[1]) if len(sys.argv) > 1 else 7)
