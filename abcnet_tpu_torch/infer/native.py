"""ctypes bindings for the native graph assembler (native/assemble.cpp).

The library builds at first use from the repo's `native/assemble.cpp`
and `native/smiles.cpp`, with the port's batched entry point
`csrc/assemble_batch.cpp`, into the port's gitignored build directory,
with the flags of `native/Makefile` (utils/build.py). `load_native()`
returns None when it cannot be built (no g++), and callers fall back to
the pure-numpy path in infer/assemble.py. Both implement the same
reference semantics (img2smiles2.py:171-311); the tests assert they
agree.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import build

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)

# The peak arrays of assemble_smiles_batch, in the order of its `Field`
# enum (csrc/assemble_batch.cpp): (key, dtype, the key whose shape gives
# its rows and slots, whether a slot is a pair). The last three may be
# absent.
BATCH_FIELDS = (
    ("atom_xy", np.int32, "atom_valid", True),
    ("atom_type", np.int32, "atom_valid", False),
    ("atom_charge", np.int32, "atom_valid", False),
    ("atom_hs", np.int32, "atom_valid", False),
    ("atom_valid", np.uint8, "atom_valid", False),
    ("bond_xy", np.int32, "bond_valid", True),
    ("bond_delta", np.float32, "bond_valid", True),
    ("bond_type", np.int32, "bond_valid", False),
    ("bond_valid", np.uint8, "bond_valid", False),
    ("bond_score", np.float32, "bond_valid", False),
    ("atom_sub", np.float32, "atom_valid", True),
    ("bond_sub", np.float32, "bond_valid", True),
)
_OPTIONAL = ("bond_score", "atom_sub", "bond_sub")
# First size of assemble_smiles_batch's SMILES buffer, bytes a row (the
# serving mix's SMILES average some 50).
_SMILES_BYTES_A_ROW = 256


# ABI version this binding targets; must match
# abcnet_native_abi_version() exported by native/assemble.cpp. A stale
# .so built before a signature change loads fine under ctypes and
# silently ignores trailing arguments (x86-64 calling convention), so
# version-gate instead of trusting the file.
_ABI_VERSION = 6


@functools.lru_cache(maxsize=1)
def load_native() -> Optional[ctypes.CDLL]:
    try:
        lib = build.load(build.NATIVE)
    except (OSError, RuntimeError) as e:
        warnings.warn(f"native assembler unavailable ({e}); using the "
                      "numpy assembler")
        return None
    try:
        lib.abcnet_native_abi_version.restype = ctypes.c_int32
        lib.abcnet_native_abi_version.argtypes = []
        version = int(lib.abcnet_native_abi_version())
    except AttributeError:
        version = 1  # predates the version export
    if version != _ABI_VERSION:
        warnings.warn(
            f"native assembler: ABI version {version} != expected "
            f"{_ABI_VERSION}. Falling back to the numpy assembler.")
        return None
    lib.assemble_smiles_batch.restype = ctypes.c_int64
    lib.assemble_smiles_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p), _I64P,
        ctypes.c_double, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32,
        _U8P, ctypes.c_int64, _I64P, _I32P, _I64P,
    ]
    return lib


def _p(arr, typ):
    return arr.ctypes.data_as(typ)


def _rows(key, a, dtype, shape) -> Tuple[np.ndarray, int]:
    """`a` as `dtype` (np.asarray's conversion) with each row contiguous, copied only where it is not, and its row stride
    in elements. Raises where its shape is not `shape`."""
    a = np.asarray(a, dtype)
    if a.shape != shape:
        raise ValueError(f"peaks[{key!r}] has shape {a.shape}, expected "
                         f"{shape}")
    if (a.strides[0] % a.itemsize
            or not (a.shape[0] == 0 or a[0].flags.c_contiguous)):
        a = np.ascontiguousarray(a)
    return a, a.strides[0] // a.itemsize


def assemble_smiles_batch_native(peaks: Dict[str, np.ndarray],
                                 overshoot_cap: float, subcell: bool,
                                 rematch_max: float, vprune_score_max: float
                                 ) -> Optional[Tuple[List[Optional[str]],
                                                     int, int]]:
    """Every row of a peak batch through the C++ assembler and SMILES
    writer in one call (csrc/assemble_batch.cpp), which holds no Python
    object and so runs with the interpreter lock released. Returns (one
    SMILES or None a row; the nanoseconds in graph assembly; in SMILES
    writing), or None where the library is unavailable. Stereo perception
    and the aromatic salvage are on. The SMILES buffer starts at
    `_SMILES_BYTES_A_ROW` bytes a row; a call that finds it short is made
    once more with the size it asked for."""
    lib = load_native()
    if lib is None:
        return None
    n, ka = np.shape(peaks["atom_valid"])
    kb = np.shape(peaks["bond_valid"])[1]
    if n == 0:
        return [], 0, 0
    rows = {"atom_valid": (n, ka), "bond_valid": (n, kb)}
    held, ptrs = [], (ctypes.c_void_p * len(BATCH_FIELDS))()
    strides = np.zeros(len(BATCH_FIELDS), np.int64)
    for i, (key, dtype, like, pair) in enumerate(BATCH_FIELDS):
        if key in _OPTIONAL and key not in peaks:
            continue
        a, strides[i] = _rows(key, peaks[key], dtype,
                              rows[like] + ((2,) if pair else ()))
        held.append(a)                # alive until the call returns
        ptrs[i] = a.ctypes.data
    offset = np.zeros(n, np.int64)
    length = np.zeros(n, np.int32)
    ns = np.zeros(2, np.int64)
    cap = _SMILES_BYTES_A_ROW * n
    graph_ns = smiles_ns = 0
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        need = lib.assemble_smiles_batch(
            n, ka, kb, ptrs, _p(strides, _I64P), overshoot_cap,
            1 if subcell else 0, rematch_max, vprune_score_max, 1, 1,
            _p(out, _U8P), cap, _p(offset, _I64P), _p(length, _I32P),
            _p(ns, _I64P))
        graph_ns += int(ns[0])
        smiles_ns += int(ns[1])
        if need <= cap:
            break
        cap = need
    else:
        raise RuntimeError("assemble_smiles_batch found its second buffer "
                           "short")
    text = out[:need].tobytes()
    return ([None if m < 0 else text[o:o + m].decode("ascii")
             for o, m in zip(offset.tolist(), length.tolist())],
            graph_ns, smiles_ns)
