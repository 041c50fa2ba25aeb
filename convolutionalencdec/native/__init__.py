"""Native C++ oracle codec, loaded via ctypes.

Builds `libfec_oracle.so` from fec_oracle.cpp on first use (g++ is part of
the baked toolchain).  This is the framework's independent-implementation
ground truth, playing the role MATLAB convenc/vitdec played for the
reference (SURVEY.md §4 item 4).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..params import CodeSpec

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fec_oracle.cpp")
_SO = os.path.join(_HERE, "libfec_oracle.so")
_lock = threading.Lock()
_lib = None


def _build(src: str, so: str) -> None:
    """THE build recipe (also what the Makefile's native target runs):
    honors CXX/CXXFLAGS env overrides so an mtime-triggered rebuild
    uses the same compiler the user built with."""
    cxx = os.environ.get("CXX", "g++")
    flags = os.environ.get("CXXFLAGS", "-O2").split()
    subprocess.run(
        [cxx, *flags, "-shared", "-fPIC", "-std=c++17", src, "-o", so],
        check=True, capture_output=True)


def _stale(src: str, so: str) -> bool:
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src))


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the oracle shared library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale(_SRC, _SO):
            _build(_SRC, _SO)
        lib = ctypes.CDLL(_SO)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fec_oracle_encode.restype = ctypes.c_int
        lib.fec_oracle_encode.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u64p,
            u8p, ctypes.c_int, ctypes.c_int, u8p]
        lib.fec_oracle_decode.restype = ctypes.c_int
        lib.fec_oracle_decode.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u64p,
            u8p, ctypes.c_int, u8p]
        _lib = lib
        return lib


def _gptr(spec: CodeSpec):
    g = np.asarray(spec.g, dtype=np.uint64)
    return g, g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def oracle_encode(spec: CodeSpec, bits, terminate: bool = True) -> np.ndarray:
    """Encode 0/1 bits with the C++ oracle.  Returns uint8 segments."""
    lib = get_lib()
    bits = np.ascontiguousarray(np.asarray(bits, dtype=np.uint8).ravel())
    if bits.size % spec.k:
        raise ValueError("bit count not a multiple of k")
    T = bits.size // spec.k + (spec.S if terminate else 0)
    out = np.zeros(T, dtype=np.uint8)
    g, gp = _gptr(spec)
    nt = lib.fec_oracle_encode(
        spec.K, spec.k, spec.n, gp,
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bits.size,
        int(terminate), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert nt == T
    return out


def oracle_decode(spec: CodeSpec, segments) -> np.ndarray:
    """Hard-decision block decode with the C++ oracle.  Returns uint8 bits."""
    lib = get_lib()
    segments = np.ascontiguousarray(
        np.asarray(segments, dtype=np.uint8).ravel())
    L = (segments.size - spec.S) * spec.k
    out = np.zeros(L, dtype=np.uint8)
    g, gp = _gptr(spec)
    nb = lib.fec_oracle_decode(
        spec.K, spec.k, spec.n, gp,
        segments.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        segments.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert nb == L
    return out


# ---------------------------------------------------------------------------
# Turbo (PCCC) oracle — independent C++ implementation of the chain in
# ops/turbo.py, used to pin the statistical acceptance constants
# (tests/test_turbo_oracle.py, chip_smoke.py) the way MATLAB
# pinned berTestK7's (SURVEY.md §4 item 4).

_TSRC = os.path.join(_HERE, "turbo_oracle.cpp")
_TSO = os.path.join(_HERE, "libturbo_oracle.so")
_tlib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def get_turbo_lib() -> ctypes.CDLL:
    """Load (building if needed) the turbo oracle shared library."""
    global _tlib
    with _lock:
        if _tlib is not None:
            return _tlib
        if _stale(_TSRC, _TSO):
            _build(_TSRC, _TSO)
        lib = ctypes.CDLL(_TSO)
        lib.turbo_oracle_encode.restype = None
        lib.turbo_oracle_encode.argtypes = [
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
            _u8p, ctypes.c_int, _i32p, _u8p, _u8p, _u8p, _u8p]
        lib.turbo_oracle_decode.restype = None
        lib.turbo_oracle_decode.argtypes = [
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, ctypes.c_int, _u8p]
        lib.turbo_oracle_ber_point.restype = None
        lib.turbo_oracle_ber_point.argtypes = [
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
            _i32p, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, _i64p,
            ctypes.POINTER(ctypes.c_int32)]
        _tlib = lib
        return lib


def _c32(a):
    a = np.ascontiguousarray(np.asarray(a, np.int32))
    return a, a.ctypes.data_as(_i32p)


def turbo_oracle_encode(rsc, bits, perm):
    """Oracle turbo encode of one block.  Returns the same stream dict
    as ops.turbo.turbo_encode_np."""
    lib = get_turbo_lib()
    bits = np.ascontiguousarray(np.asarray(bits, np.uint8))
    L, S = bits.size, rsc.S
    perm, pp = _c32(perm)
    par1 = np.zeros(L, np.uint8)
    par2 = np.zeros(L, np.uint8)
    t1 = np.zeros(2 * S, np.uint8)
    t2 = np.zeros(2 * S, np.uint8)
    lib.turbo_oracle_encode(
        rsc.K, rsc.g_fb, rsc.g_fw,
        bits.ctypes.data_as(_u8p), L, pp,
        par1.ctypes.data_as(_u8p), par2.ctypes.data_as(_u8p),
        t1.ctypes.data_as(_u8p), t2.ctypes.data_as(_u8p))
    return {"sys": bits, "par1": par1, "par2": par2,
            "sys_tail1": t1[0::2], "par_tail1": t1[1::2],
            "sys_tail2": t2[0::2], "par_tail2": t2[1::2]}


def turbo_oracle_decode(rsc, l_sys, l_par1, l_par2, l_sys_tail1,
                        l_par_tail1, l_sys_tail2, l_par_tail2, perm,
                        n_iters: int = 6):
    """Oracle iterative max-log-MAP decode of one block -> uint8 bits."""
    lib = get_turbo_lib()
    perm, pp = _c32(perm)
    L, S = len(perm), rsc.S
    ls, lsp = _c32(l_sys)
    p1, p1p = _c32(l_par1)
    p2, p2p = _c32(l_par2)
    t1 = np.empty(2 * S, np.int32)
    t1[0::2], t1[1::2] = np.asarray(l_sys_tail1), np.asarray(l_par_tail1)
    t2 = np.empty(2 * S, np.int32)
    t2[0::2], t2[1::2] = np.asarray(l_sys_tail2), np.asarray(l_par_tail2)
    out = np.zeros(L, np.uint8)
    lib.turbo_oracle_decode(
        rsc.K, rsc.g_fb, rsc.g_fw, L, pp, lsp, p1p, p2p,
        t1.ctypes.data_as(_i32p), t2.ctypes.data_as(_i32p),
        n_iters, out.ctypes.data_as(_u8p))
    return out


def turbo_oracle_ber_point(rsc, L: int, perm, ebn0_db: float, *,
                           qmax: int = 31, n_blocks: int = 1000,
                           n_iters: int = 6, seed: int = 9865):
    """Self-contained oracle BER/BLER campaign (rate-1/3, AWGN/BPSK,
    the harness' 3-sigma AGC quantizer).  Returns (ber, bler)."""
    lib = get_turbo_lib()
    perm, pp = _c32(perm)
    be = ctypes.c_int64(0)
    blk = ctypes.c_int32(0)
    lib.turbo_oracle_ber_point(
        rsc.K, rsc.g_fb, rsc.g_fw, L, pp, float(ebn0_db), qmax,
        n_blocks, n_iters, seed, ctypes.byref(be), ctypes.byref(blk))
    return be.value / (n_blocks * L), blk.value / n_blocks
