"""ctypes bindings for the native graph assembler (native/assemble.cpp).

The library builds at first use from the repo's `native/assemble.cpp`
and `native/smiles.cpp` into the port's gitignored build directory, with
the flags of `native/Makefile` (utils/build.py). `load_native()` returns
None when it cannot be built (no g++), and callers fall back to the
pure-numpy path in infer/assemble.py. Both implement the same reference
semantics (img2smiles2.py:171-311); the tests assert they agree.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils import build

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)


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
    lib.assemble_graph.restype = ctypes.c_int32
    lib.assemble_graph.argtypes = [
        _I32P, _I32P, _I32P, _I32P, _U8P, ctypes.c_int32,
        _I32P, _F32P, _I32P, _U8P, ctypes.c_int32,
        _F64P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
        ctypes.c_double, _F32P, _F32P, ctypes.c_double,
        _F32P, ctypes.c_double,
    ]
    lib.graph_to_smiles.restype = ctypes.c_int32
    lib.graph_to_smiles.argtypes = [
        _F64P, _I32P, _I32P, _I32P, ctypes.c_int32,
        _I32P, _I32P, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int32,
    ]
    return lib


def _p(arr, typ):
    return arr.ctypes.data_as(typ)


def graph_to_smiles_native(pos: np.ndarray, type_cls: np.ndarray,
                           charge_cls: np.ndarray, hs: np.ndarray,
                           bond_pairs: np.ndarray, orders: np.ndarray,
                           perceive_stereo: bool = True,
                           salvage_aromatic: bool = True) -> Optional[str]:
    """C++ canonical-SMILES tail (native/smiles.cpp): decoded graph ->
    molblock semantics -> sanitize -> stereo -> canonical isomeric
    SMILES. Inputs use assemble_graph's output conventions (0-based bond
    indices, molblock orders 1..6). Returns None both when the molecule
    is rejected (parity with the Python path returning None) and when
    the library is unavailable — callers distinguish via load_native().
    """
    lib = load_native()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, np.float64)
    type_cls = np.ascontiguousarray(type_cls, np.int32)
    charge_cls = np.ascontiguousarray(charge_cls, np.int32)
    hs = np.ascontiguousarray(hs, np.int32)
    bond_pairs = np.ascontiguousarray(bond_pairs, np.int32)
    orders = np.ascontiguousarray(orders, np.int32)
    na = np.int32(type_cls.shape[0])
    nb = np.int32(orders.shape[0])
    cap = 4096
    buf = ctypes.create_string_buffer(cap)
    n = lib.graph_to_smiles(
        _p(pos, _F64P), _p(type_cls, _I32P), _p(charge_cls, _I32P),
        _p(hs, _I32P), na, _p(bond_pairs, _I32P), _p(orders, _I32P), nb,
        np.int32(1 if perceive_stereo else 0),
        np.int32(1 if salvage_aromatic else 0), buf, np.int32(cap))
    if n == -2:  # buffer too small: retry once with a generous cap
        cap = 1 << 20
        buf = ctypes.create_string_buffer(cap)
        n = lib.graph_to_smiles(
            _p(pos, _F64P), _p(type_cls, _I32P), _p(charge_cls, _I32P),
            _p(hs, _I32P), na, _p(bond_pairs, _I32P), _p(orders, _I32P),
            nb, np.int32(1 if perceive_stereo else 0),
            np.int32(1 if salvage_aromatic else 0), buf, np.int32(cap))
    if n < 0:
        return None
    return buf.value.decode("ascii")


def assemble_graph_native(peaks: Dict[str, np.ndarray], index: int,
                          overshoot_cap: Optional[float] = None,
                          subcell: bool = True,
                          rematch_max: Optional[float] = None,
                          vprune_score_max: Optional[float] = None
                          ) -> Optional[Tuple]:
    """Run the C++ assembler for one image. Returns
    (atom_pos [A,2], atom_type [A], atom_charge [A], atom_hs [A],
     bonds [B,2] 0-based, bond_orders [B]) or None.

    subcell: when the peaks carry atom_sub/bond_sub offsets
    (infer/decode.py:subcell_offsets), dedup + endpoint matching use the
    refined coordinates; atom_pos still returns integer cells."""
    lib = load_native()
    if lib is None:
        return None
    if overshoot_cap is None:
        from .assemble import OVERSHOOT_CAP  # single source of truth
        overshoot_cap = OVERSHOOT_CAP
    if rematch_max is None:
        from .assemble import REMATCH_MAX
        rematch_max = REMATCH_MAX
    if vprune_score_max is None:
        from .assemble import VPRUNE_SCORE_MAX
        vprune_score_max = VPRUNE_SCORE_MAX

    axy = np.ascontiguousarray(peaks["atom_xy"][index], np.int32)
    at = np.ascontiguousarray(peaks["atom_type"][index], np.int32)
    ac = np.ascontiguousarray(peaks["atom_charge"][index], np.int32)
    ah = np.ascontiguousarray(peaks["atom_hs"][index], np.int32)
    av = np.ascontiguousarray(peaks["atom_valid"][index], np.uint8)
    bxy = np.ascontiguousarray(peaks["bond_xy"][index], np.int32)
    bd = np.ascontiguousarray(peaks["bond_delta"][index], np.float32)
    bt = np.ascontiguousarray(peaks["bond_type"][index], np.int32)
    bv = np.ascontiguousarray(peaks["bond_valid"][index], np.uint8)
    bsc = (np.ascontiguousarray(peaks["bond_score"][index], np.float32)
           if "bond_score" in peaks else None)
    ka = np.int32(axy.shape[0])
    kb = np.int32(bxy.shape[0])

    out_pos = np.zeros((ka, 2), np.float64)
    out_type = np.zeros(ka, np.int32)
    out_charge = np.zeros(ka, np.int32)
    out_hs = np.zeros(ka, np.int32)
    out_bonds = np.zeros((kb, 2), np.int32)
    out_btype = np.zeros(kb, np.int32)
    n_bonds = np.zeros(1, np.int32)

    asub = bsub = None
    if subcell and "atom_sub" in peaks:
        asub = np.ascontiguousarray(peaks["atom_sub"][index], np.float32)
        bsub = np.ascontiguousarray(peaks["bond_sub"][index], np.float32)
    null_f32 = ctypes.cast(None, _F32P)
    na = lib.assemble_graph(
        _p(axy, _I32P), _p(at, _I32P), _p(ac, _I32P), _p(ah, _I32P),
        _p(av, _U8P), ka,
        _p(bxy, _I32P), _p(bd, _F32P), _p(bt, _I32P), _p(bv, _U8P), kb,
        _p(out_pos, _F64P), _p(out_type, _I32P), _p(out_charge, _I32P),
        _p(out_hs, _I32P), _p(out_bonds, _I32P), _p(out_btype, _I32P),
        _p(n_bonds, _I32P), ctypes.c_double(overshoot_cap),
        _p(asub, _F32P) if asub is not None else null_f32,
        _p(bsub, _F32P) if bsub is not None else null_f32,
        ctypes.c_double(rematch_max),
        _p(bsc, _F32P) if bsc is not None else null_f32,
        ctypes.c_double(vprune_score_max))
    if na < 0:
        return None
    nb = int(n_bonds[0])
    return (out_pos[:na], out_type[:na], out_charge[:na], out_hs[:na],
            out_bonds[:nb], out_btype[:nb])
