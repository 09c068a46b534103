"""ctypes bindings for the native SSP decimation engine.

The greedy SSP collapse loop (reference src/SSP_midpoint.cpp:119-245,
src/SSP_collapse_edge.cpp) is inherently sequential host code with dynamic
topology — the wrong shape for a data-parallel device — so, like the reference, it lives in
native code (C++, `native/ssp.cpp`) and emits flat arrays the device side
consumes.  The library is compiled on demand with g++ (no external deps —
the tiny dense solves are hand-rolled) and cached next to the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SOURCES = ["ssp.cpp", "dense.hpp", "lscm.hpp", "mesh.hpp"]
_LOCK = threading.Lock()
_LIB = None

i64 = ctypes.c_int64
p_i64 = ctypes.POINTER(ctypes.c_int64)
p_f64 = ctypes.POINTER(ctypes.c_double)


_BUILD_TAG = b"v3"  # bump when compile flags change


def _source_hash() -> str:
    import platform

    # include the host ISA: a -march=native artifact must never be reused
    # on a different CPU (SIGILL)
    h = hashlib.sha256(_BUILD_TAG + platform.machine().encode())
    try:
        h.update(open("/proc/cpuinfo", "rb").read(4096))
    except OSError:
        pass
    for s in _SOURCES:
        h.update((_NATIVE_DIR / s).read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    base = [
        "g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
        str(_NATIVE_DIR / "ssp.cpp"),
    ]
    h = _source_hash()
    last_err = None
    for extra, tag in ((["-march=native"], "native"), ([], "portable")):
        out = _NATIVE_DIR / f"libssp-{h}-{tag}.so"
        if out.exists():
            return out
        # atomic publish: concurrent builders each write a private temp and
        # os.replace it; readers only ever see a complete artifact
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        try:
            subprocess.run(
                base[:1] + extra + base[1:] + ["-o", str(tmp)],
                check=True, capture_output=True, text=True,
            )
        except subprocess.CalledProcessError as e:
            last_err = e
            if "march" not in (e.stderr or ""):
                break  # genuine source error — don't mask it with a retry
            continue
        os.replace(tmp, out)
        return out
    raise RuntimeError(
        f"native build failed:\n{last_err.stderr if last_err else ''}"
    )


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            lib.ssp_decimate.restype = ctypes.c_void_p
            lib.ssp_decimate.argtypes = [
                p_f64, i64, p_i64, i64, i64,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.ssp_result_sizes.argtypes = [ctypes.c_void_p, p_i64]
            lib.ssp_result_fill.argtypes = [ctypes.c_void_p] + [p_f64, p_i64] * 1 + [
                p_i64, p_i64, p_i64,            # IM, IMF, FIM
                p_i64, p_i64, p_i64,            # b, voff, subset
                p_f64, p_f64,                   # uv_pre, uv_post
                p_i64, p_i64, p_i64,            # foff_pre, fuv_pre, fidx_pre
                p_i64, p_i64, p_i64,            # foff_post, fuv_post, fidx_post
                p_i64, p_i64,                   # dim_off, dim_dat
            ]
            lib.ssp_result_free.argtypes = [ctypes.c_void_p]
            lib.ssp_greedy_coloring.restype = i64
            lib.ssp_greedy_coloring.argtypes = [
                i64, p_i64, p_i64, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.ssp_query.argtypes = [
                i64, p_i64, p_i64, p_i64, p_f64, p_f64,
                p_i64, p_i64, p_i64, p_i64, p_i64, p_i64,
                p_i64, p_i64, ctypes.c_int, i64, p_f64, p_i64, p_i64,
            ]
            _LIB = lib
    return _LIB


def _pd(a: np.ndarray):
    return a.ctypes.data_as(p_f64)


def _pi(a: np.ndarray):
    return a.ctypes.data_as(p_i64)


def decimate(V, F, tarF, dec_type, random_variant=False, seed=0, verbose=False):
    """Run the native decimator; returns a dict of flat numpy arrays
    (the serialized SSP collapse log) or None on failure (non-manifold)."""
    lib = get_lib()
    V = np.ascontiguousarray(V, dtype=np.float64)
    F = np.ascontiguousarray(F, dtype=np.int64)
    h = lib.ssp_decimate(
        _pd(V), V.shape[0], _pi(F), F.shape[0], int(tarF), int(dec_type),
        1 if random_variant else 0, int(seed), 1 if verbose else 0,
    )
    try:
        sizes = np.zeros(10, dtype=np.int64)
        lib.ssp_result_sizes(h, _pi(sizes))
        ok, clean, nVc, nFc, n, totV, tfp, tfq, nFw, tdim = (int(x) for x in sizes)
        if not ok:
            return None
        out = {
            "clean_finish": bool(clean),
            "V": np.zeros((nVc, 3)),
            "F": np.zeros((nFc, 3), dtype=np.int64),
            "IM": np.zeros(nVc, dtype=np.int64),
            "IMF": np.zeros(nFc, dtype=np.int64),
            "FIM": np.zeros(nFw, dtype=np.int64),
            "b": np.zeros((n, 2), dtype=np.int64),
            "voff": np.zeros(n + 1, dtype=np.int64),
            "subset": np.zeros(totV, dtype=np.int64),
            "uv_pre": np.zeros((totV, 2)),
            "uv_post": np.zeros((totV, 2)),
            "foff_pre": np.zeros(n + 1, dtype=np.int64),
            "fuv_pre": np.zeros((tfp, 3), dtype=np.int64),
            "fidx_pre": np.zeros(tfp, dtype=np.int64),
            "foff_post": np.zeros(n + 1, dtype=np.int64),
            "fuv_post": np.zeros((tfq, 3), dtype=np.int64),
            "fidx_post": np.zeros(tfq, dtype=np.int64),
            "dim_off": np.zeros(nFw + 1, dtype=np.int64),
            "dim_dat": np.zeros(tdim, dtype=np.int64),
        }
        lib.ssp_result_fill(
            h, _pd(out["V"]), _pi(out["F"]), _pi(out["IM"]), _pi(out["IMF"]),
            _pi(out["FIM"]), _pi(out["b"]), _pi(out["voff"]), _pi(out["subset"]),
            _pd(out["uv_pre"]), _pd(out["uv_post"]), _pi(out["foff_pre"]),
            _pi(out["fuv_pre"]), _pi(out["fidx_pre"]), _pi(out["foff_post"]),
            _pi(out["fuv_post"]), _pi(out["fidx_post"]), _pi(out["dim_off"]),
            _pi(out["dim_dat"]),
        )
        return out
    finally:
        lib.ssp_result_free(h)


def greedy_coloring_csr(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Native greedy coloring of a CSR sparsity (for multi-color GS)."""
    lib = get_lib()
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    color = np.zeros(n, dtype=np.int32)
    lib.ssp_greedy_coloring(
        n, _pi(indptr), _pi(indices), color.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    )
    return color


def query_walk(log: dict, forward: bool, BC, BF, FIdx):
    """In-place walk of query points through the collapse log
    (working-mesh index space; see query/maps.py for the user-facing
    wrappers that handle coarse-index remapping)."""
    lib = get_lib()
    BC = np.ascontiguousarray(BC, dtype=np.float64)
    BF = np.ascontiguousarray(BF, dtype=np.int64)
    FIdx = np.ascontiguousarray(FIdx, dtype=np.int64)
    n = int(log["voff"].shape[0] - 1)
    lib.ssp_query(
        n, _pi(log["b"]), _pi(log["voff"]), _pi(log["subset"]),
        _pd(log["uv_pre"]), _pd(log["uv_post"]), _pi(log["foff_pre"]),
        _pi(log["fuv_pre"]), _pi(log["fidx_pre"]), _pi(log["foff_post"]),
        _pi(log["fuv_post"]), _pi(log["fidx_post"]), _pi(log["dim_off"]),
        _pi(log["dim_dat"]), 1 if forward else 0, BC.shape[0],
        _pd(BC), _pi(BF), _pi(FIdx),
    )
    return BC, BF, FIdx
