"""Native (C++) host-side kernels with lazy compilation + numpy fallback.

The port's own copy of the JAX package's native map operations: it compiles
``orbslam3_tpu_torch/csrc/mapops.cpp`` (kept byte-equal to the reference's
source by a test) into this package's build directory,
``orbslam3_tpu_torch/build/``, and binds it with ctypes. Falls back to numpy
implementations when no compiler is present; :func:`available` says which.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_SRC = os.path.join(_PKG, "csrc", "mapops.cpp")
_BUILD = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD, "libmapops.so")
_lib = None
_tried = False
_error = None      # why the native library is unavailable (repr of the exception)


def _compile():
    """g++ into a temporary name, then an atomic rename: concurrent
    processes never load half a library."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
                        "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _compile()
        lib = ctypes.CDLL(_SO)
        i64 = ctypes.c_int64
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.covisibility_row.argtypes = [p32, pu8, i64, i64, i64, i64, p32]
        lib.obs_counts.argtypes = [p32, pu8, i64, i64, i64, p32]
        lib.observations_of.argtypes = [p32, pu8, i64, i64, pu8, i64, p32, p32, i64]
        lib.observations_of.restype = i64
        lib.replace_points.argtypes = [p32, i64, i64, p32, i64]
        pf32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        pu32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.refresh_points.argtypes = [
            p32, pu8, pu32, p32, pf32, pf32, i64, i64, p64, i64, pf32, pf32,
            i64, i64, pu32, pf32, pf32, pf32, pu8]
        lib.kf_redundancy.argtypes = [
            p32, pu8, p32, pf32, ctypes.c_double, i64, i64, p32, i64, i64,
            p32, p32]
        _lib = lib
    except Exception as e:
        _lib = None
        _error = repr(e) + (getattr(e, "stderr", b"") or b"").decode(errors="replace")[-2000:]
    return _lib


def available() -> bool:
    return _load() is not None


def unavailable_because() -> str | None:
    """Why :func:`available` is False (None when the library loaded)."""
    _load()
    return _error


def covisibility_row(feat_mp: np.ndarray, kf_valid: np.ndarray, kf: int,
                     max_mp: int) -> np.ndarray:
    lib = _load()
    n_kf, n_feat = feat_mp.shape
    if lib is None:
        row = feat_mp[kf]
        mps = row[row >= 0]
        out = np.isin(feat_mp, mps).sum(axis=1).astype(np.int32)
        out[kf] = 0
        out[~kf_valid.astype(bool)] = 0
        return out
    out = np.zeros(n_kf, np.int32)
    lib.covisibility_row(np.ascontiguousarray(feat_mp),
                         np.ascontiguousarray(kf_valid, np.uint8),
                         n_kf, n_feat, kf, max_mp, out)
    return out


def obs_counts(feat_mp: np.ndarray, kf_valid: np.ndarray, max_mp: int) -> np.ndarray:
    lib = _load()
    n_kf, n_feat = feat_mp.shape
    if lib is None:
        fm = feat_mp[kf_valid.astype(bool)]
        return np.bincount(fm[fm >= 0], minlength=max_mp).astype(np.int32)
    out = np.zeros(max_mp, np.int32)
    lib.obs_counts(np.ascontiguousarray(feat_mp),
                   np.ascontiguousarray(kf_valid, np.uint8),
                   n_kf, n_feat, max_mp, out)
    return out


def observations_of(feat_mp: np.ndarray, kf_valid: np.ndarray,
                    mp_ids: np.ndarray, max_mp: int):
    lib = _load()
    n_kf, n_feat = feat_mp.shape
    if lib is None:
        sel = np.isin(feat_mp, mp_ids) & (feat_mp >= 0) \
            & kf_valid.astype(bool)[:, None]
        kf_idx, feat_idx = np.nonzero(sel)
        return kf_idx.astype(np.int32), feat_idx.astype(np.int32)
    wanted = np.zeros(max_mp, np.uint8)
    wanted[mp_ids] = 1
    cap = n_kf * n_feat
    out_kf = np.zeros(cap, np.int32)
    out_feat = np.zeros(cap, np.int32)
    n = lib.observations_of(np.ascontiguousarray(feat_mp),
                            np.ascontiguousarray(kf_valid, np.uint8),
                            n_kf, n_feat, wanted, max_mp, out_kf, out_feat, cap)
    return out_kf[:n].copy(), out_feat[:n].copy()


def refresh_points(feat_mp, kf_valid, kf_desc, kf_octave, kf_R, kf_t,
                   mp_ids, mp_xyz, scale_factors,
                   mp_desc, mp_normal, mp_min, mp_max):
    """Distinctive descriptor + normal + scale range for the given points,
    written in place; returns alive mask (False = no observation left).
    Returns None when the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    n_kf, n_feat = feat_mp.shape
    n_ids = len(mp_ids)
    alive = np.zeros(n_ids, np.uint8)
    if n_ids == 0:
        return alive.astype(bool)
    lib.refresh_points(
        np.ascontiguousarray(feat_mp), np.ascontiguousarray(kf_valid, np.uint8),
        np.ascontiguousarray(kf_desc), np.ascontiguousarray(kf_octave),
        np.ascontiguousarray(kf_R), np.ascontiguousarray(kf_t),
        n_kf, n_feat, np.ascontiguousarray(mp_ids, np.int64), n_ids,
        np.ascontiguousarray(mp_xyz),
        np.ascontiguousarray(scale_factors, np.float32),
        len(scale_factors), mp_xyz.shape[0],
        mp_desc, mp_normal, mp_min, mp_max, alive)
    return alive.astype(bool)


def kf_redundancy(feat_mp, kf_valid, kf_octave, kf_depth, th_depth,
                  cand, max_mp):
    """(redundant, total) point counts per candidate keyframe (reference
    KeyFrameCulling redundancy test, scale-aware). None if no native lib."""
    lib = _load()
    if lib is None:
        return None
    n_kf, n_feat = feat_mp.shape
    cand = np.ascontiguousarray(cand, np.int32)
    red = np.zeros(len(cand), np.int32)
    tot = np.zeros(len(cand), np.int32)
    if len(cand) == 0:
        return red, tot
    lib.kf_redundancy(
        np.ascontiguousarray(feat_mp), np.ascontiguousarray(kf_valid, np.uint8),
        np.ascontiguousarray(kf_octave),
        np.ascontiguousarray(kf_depth, np.float32), float(th_depth),
        n_kf, n_feat, cand, len(cand), max_mp, red, tot)
    return red, tot


def replace_points(feat_mp: np.ndarray, lut: np.ndarray, max_mp: int) -> None:
    """In-place id rewrite + per-KF dedup. feat_mp: (n_kf, n_feat) int32."""
    lib = _load()
    n_kf, n_feat = feat_mp.shape
    if lib is None:
        pos = feat_mp >= 0
        feat_mp[pos] = lut[feat_mp[pos]]
        for k in range(n_kf):
            row = feat_mp[k]
            seen = set()
            for i, v in enumerate(row):
                if v >= 0:
                    if v in seen:
                        row[i] = -1
                    else:
                        seen.add(int(v))
        return
    lib.replace_points(np.ascontiguousarray(feat_mp), n_kf, n_feat,
                       np.ascontiguousarray(lut, np.int32), max_mp)
