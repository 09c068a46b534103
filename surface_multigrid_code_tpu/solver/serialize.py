"""Device build-artifact serialization (SURVEY §5.4 extended device-side).

The reference's only persisted precompute is the collapse log (the SSP
hierarchy, mirrored by `hierarchy.save_hierarchy`); everything downstream
is rebuilt per process.  The downstream build is not free at
icosphere-9 scale, and every device layout is a deterministic function of
the hierarchy — so the device containers are serializable too:
`save_device_hierarchy` / `load_device_hierarchy` round-trip a solver's
`DeviceHierarchy` (ELL operators, diagonals, Chebyshev bounds, dense
coarse inverse) through a single .npz.

The encoder walks the closed set of framework containers via their
pytree (children, aux) contract — aux is JSON-serializable by
construction — so any nested structure of {DeviceHierarchy, DeviceLevel,
ELLMatrix, BSRMatrix, dict, tuple/list, ndarray, scalars, None} can be persisted (`save_pytree` / `load_pytree`)."""

from __future__ import annotations

import json

import numpy as np

import jax.numpy as jnp


def _registry():
    from surface_multigrid_code_tpu.ops.sparse import ELLMatrix
    from surface_multigrid_code_tpu.solver.vcycle import (
        DeviceHierarchy,
        DeviceLevel,
    )
    from surface_multigrid_code_tpu.solver.bsr import BSRMatrix

    return {
        "ELLMatrix": ELLMatrix,
        "DeviceLevel": DeviceLevel,
        "DeviceHierarchy": DeviceHierarchy,
        "BSRMatrix": BSRMatrix,
    }


def _encode(obj, arrays: dict):
    """Array leaves get sequential keys ("a0", "a1", ...) — collision-
    free by construction (user-controlled dict keys must never feed the
    npz namespace: "a"/"b" vs "a.b" style paths would alias)."""
    reg = _registry()
    for name, cls in reg.items():
        if isinstance(obj, cls):
            children, aux = obj.tree_flatten()
            return {
                "t": name,
                "aux": _encode_aux(aux),
                "c": [_encode(ch, arrays) for ch in children],
            }
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (tuple, list)):
        return {
            "t": "tuple" if isinstance(obj, tuple) else "list",
            "c": [_encode(ch, arrays) for ch in obj],
        }
    if isinstance(obj, dict):
        keys = sorted(obj)
        if any(not isinstance(k, str) for k in keys):
            raise TypeError("only str dict keys are serializable")
        return {
            "t": "dict",
            "k": keys,
            "c": [_encode(obj[k], arrays) for k in keys],
        }
    if isinstance(obj, (jnp.ndarray, np.ndarray)):
        key = f"a{len(arrays)}"
        arrays[key] = np.asarray(obj)
        return {"t": "arr", "key": key}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "lit", "v": obj}
    raise TypeError(f"cannot serialize {type(obj)!r}")


def _encode_aux(aux):
    """aux fields are (nested) tuples of JSON scalars/None by the pytree
    contract; keep tuple-ness explicit so round-trips are exact."""
    if aux is None:
        return None
    if isinstance(aux, tuple):
        return {"tuple": [_encode_aux(a) for a in aux]}
    if isinstance(aux, (bool, int, float, str)):
        return aux
    raise TypeError(f"cannot serialize aux {type(aux)!r}")


def _decode_aux(spec):
    if spec is None:
        return None
    if isinstance(spec, dict):
        return tuple(_decode_aux(a) for a in spec["tuple"])
    return spec


def _decode(spec, arrays):
    reg = _registry()
    t = spec["t"]
    if t == "none":
        return None
    if t == "arr":
        return jnp.asarray(arrays[spec["key"]])
    if t == "lit":
        return spec["v"]
    if t in ("tuple", "list"):
        seq = [_decode(c, arrays) for c in spec["c"]]
        return tuple(seq) if t == "tuple" else seq
    if t == "dict":
        return {
            k: _decode(c, arrays) for k, c in zip(spec["k"], spec["c"])
        }
    cls = reg[t]
    children = tuple(_decode(c, arrays) for c in spec["c"])
    return cls.tree_unflatten(_decode_aux(spec["aux"]), children)


def save_pytree(path, obj) -> None:
    """Persist any nested structure of the framework's device containers
    (see module docstring) to one .npz."""
    arrays: dict = {}
    spec = _encode(obj, arrays)
    np.savez_compressed(
        path, __spec__=np.frombuffer(
            json.dumps(spec).encode(), dtype=np.uint8
        ), **arrays,
    )


def load_pytree(path):
    with np.load(path) as z:
        spec = json.loads(bytes(z["__spec__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__spec__"}
    return _decode(spec, arrays)


def save_device_hierarchy(path, hier) -> None:
    """Serialize a solver DeviceHierarchy (ELL operators + diagonals +
    lam_max + dense coarse inverse).  A second
    process on the same mesh skips the whole host staging pass
    (load = one npz read + device uploads)."""
    save_pytree(path, hier)


def load_device_hierarchy(path):
    return load_pytree(path)
