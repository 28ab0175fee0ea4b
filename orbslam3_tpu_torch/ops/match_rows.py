"""Masked windowed Hamming top-2 per row: the Hopper port of the Pallas
``orbslam3_tpu/ops/matching_pallas.py::match_rows``.

Two entry points, one CUDA source (``csrc/match_rows.cu``):

- :func:`match_rows` — one radius per row → ``(idx, best, second)``;
- :func:`match_rows_dual` — the same rows and columns at ``rad`` and at
  ``wide * rad`` in ONE launch → two such triples, bit for bit what two
  single-radius calls return (the tracker's motion-model retry).

Each launches its kernel for CUDA tensors and runs its plain PyTorch version
(:func:`match_rows_reference`, :func:`match_rows_dual_reference`: the pairs
inside each row's window, not the full matrix) for CPU tensors. A CUDA
tensor never takes the plain path: the kernel runs or the call raises. Each
wrapper counts its launches in ``<wrapper>.launches`` (bumped under a lock:
tracker and mapper threads both match).

The kernels build at first use from the repository's source with ``nvcc``
into ``orbslam3_tpu_torch/build/`` and are bound through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import tempfile
import threading
import time

import torch

from .matching import BIG

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "match_rows.cu")
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libmatch_rows.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def compile_source(source: str, library: str, extra_flags=(), verbose: bool = False) -> float:
    """nvcc ``source`` into the shared library ``library`` (atomically: a
    concurrent process never loads half a file); returns the seconds spent."""
    os.makedirs(os.path.dirname(library), exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp, source]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        if verbose and res.stderr:
            print(res.stderr.strip())
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0


def build(verbose: bool = False) -> float:
    """Compile the kernels into ``LIBRARY`` if it is missing or older than
    its source; returns the seconds spent compiling (0.0 when up to date)."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return 0.0
    return compile_source(SOURCE, LIBRARY, verbose=verbose)


def bind(library: str):
    """Load a built library and declare its two C entry points."""
    lib = ctypes.CDLL(library)
    vp = ctypes.c_void_p
    ci = ctypes.c_int
    lib.match_rows_launch.argtypes = [vp] * 10 + [ci] * 5 + [vp]
    lib.match_rows_launch.restype = ci
    lib.match_rows_dual_launch.argtypes = [vp] * 10 + [ci] * 5 + [ctypes.c_float, vp]
    lib.match_rows_dual_launch.restype = ci
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            _lib = bind(LIBRARY)
    return _lib


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as its 32-bit pattern), int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _window_pairs(uv, reach, lvl, row_ok, feat_xy, feat_oct, feat_ok, octave_lo, octave_hi):
    """The (row, column) pairs of valid rows and columns whose octave lies
    in range and whose offsets lie within ``reach``: rows flat over the
    batch, columns within their batch entry."""
    M, N = row_ok.shape[-1], feat_ok.shape[-1]
    B = row_ok.numel() // M
    uv, reach, lvl, row_ok = (uv.reshape(B, M, 2), reach.reshape(B, M), lvl.reshape(B, M),
                              row_ok.reshape(B, M))
    feat_xy, feat_oct, feat_ok = (feat_xy.reshape(B, N, 2), feat_oct.reshape(B, N),
                                  feat_ok.reshape(B, N))
    parts = []
    for e in range(B):
        rows = torch.nonzero(row_ok[e]).squeeze(1)
        du = torch.abs(uv[e, rows, None, 0] - feat_xy[e, None, :, 0])     # (R,N)
        i, col = torch.nonzero(du <= reach[e, rows, None], as_tuple=True)
        row = rows[i]
        dv = torch.abs(uv[e, row, 1] - feat_xy[e, col, 1])
        doct = feat_oct[e, col] - lvl[e, row]
        keep = ((dv <= reach[e, row]) & (doct >= -octave_lo) & (doct <= octave_hi)
                & feat_ok[e, col])
        parts.append((row[keep] + e * M, col[keep]))
    return tuple(torch.cat(x) for x in zip(*parts))


def _pair_distances(mp_desc, feat_desc, row, col):
    """Hamming distance of each (row, column) pair, int64."""
    N = feat_desc.shape[-2]
    a = mp_desc.reshape(-1, 8)[row]
    f = feat_desc.reshape(-1, 8)[(row // mp_desc.shape[-2]) * N + col]
    return _popcount32(a ^ f).sum(-1)


def _top2(shape, N, row, col, dist, device):
    """Per row the lowest distance, its column (the lowest among equal
    distances) and the lowest distance over the row's other columns; BIG
    (and column 0) where a row has no pair."""
    n_rows = math.prod(shape)
    key = torch.full((n_rows,), BIG * N, dtype=torch.int64, device=device).scatter_reduce(
        0, row, dist * N + col, "amin", include_self=True)
    best, idx = key // N, key % N
    other = torch.where(col == idx[row], BIG, dist)
    second = torch.full((n_rows,), BIG, dtype=torch.int64, device=device).scatter_reduce(
        0, row, other, "amin", include_self=True)
    return tuple(x.to(torch.int32).reshape(shape) for x in (idx, best, second))


def match_rows_reference(mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy,
                         feat_oct, feat_ok, octave_lo: int = 1, octave_hi: int = 1):
    """Plain PyTorch version: the pairs inside the mask (window, octave
    range, valid row and column), their Hamming distances, and per row the
    best (lowest column among ties) and the second best over the other
    columns; rows without a pair get column 0 and BIG twice. Integers
    throughout: bit for bit the masked all-pairs matrix's ``argmin`` and
    minima. Accepts an optional leading batch dimension on every argument."""
    row, col = _window_pairs(uv, rad, lvl, row_ok, feat_xy, feat_oct, feat_ok,
                             octave_lo, octave_hi)
    dist = _pair_distances(mp_desc, feat_desc, row, col)
    return _top2(row_ok.shape, feat_ok.shape[-1], row, col, dist, row_ok.device)


def match_rows_dual_reference(mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy,
                              feat_oct, feat_ok, octave_lo: int = 1, octave_hi: int = 1,
                              wide: float = 2.0):
    """Plain PyTorch version of the dual form: :func:`match_rows_reference`
    at ``rad`` and at ``wide * rad`` (one float32 product, as the kernel
    forms it), over one set of pairs and distances (those within either
    radius)."""
    rad_w = wide * rad
    row, col = _window_pairs(uv, torch.maximum(rad, rad_w), lvl, row_ok, feat_xy,
                             feat_oct, feat_ok, octave_lo, octave_hi)
    dist = _pair_distances(mp_desc, feat_desc, row, col)
    M, N = row_ok.shape[-1], feat_ok.shape[-1]
    off = torch.abs(uv.reshape(-1, 2)[row] - feat_xy.reshape(-1, 2)[(row // M) * N + col])
    out = []
    for r in (rad, rad_w):
        r = r.reshape(-1)[row]
        sel = (off[:, 0] <= r) & (off[:, 1] <= r)
        out.append(_top2(row_ok.shape, N, row[sel], col[sel], dist[sel], row_ok.device))
    return tuple(out)


# (name, dtype, trailing shape, pointer alignment the kernel needs)
_ROW_ARGS = (("mp_desc", torch.int32, (8,), 16), ("uv", torch.float32, (2,), 8),
             ("rad", torch.float32, (), 4), ("lvl", torch.int32, (), 4),
             ("row_ok", torch.bool, (), 1))
_COL_ARGS = (("feat_desc", torch.int32, (8,), 16), ("feat_xy", torch.float32, (2,), 8),
             ("feat_oct", torch.int32, (), 4), ("feat_ok", torch.bool, (), 1))


def _prepare(fn, tensors):
    """Check device, type and shape of the nine inputs and return them as
    kernel-ready tensors (a copy only where one is not contiguous or not
    aligned) with (lead, T, M, N)."""
    mp_desc, feat_desc = tensors[0], tensors[5]
    if mp_desc.device.type != "cuda":
        raise RuntimeError(f"{fn}: no kernel for device {mp_desc.device}")
    if mp_desc.dim() not in (2, 3) or feat_desc.dim() != mp_desc.dim():
        raise ValueError(f"{fn}: mp_desc/feat_desc must be (M,8)/(N,8) or (T,M,8)/(T,N,8)")
    lead = tuple(mp_desc.shape[:-2])
    M, N = mp_desc.shape[-2], feat_desc.shape[-2]
    if N < 1:
        raise ValueError(f"{fn}: needs at least one feature column")
    ins = []
    for (name, dtype, trail, align), x, n in zip(
            _ROW_ARGS + _COL_ARGS, tensors, (M,) * 5 + (N,) * 4):
        if x.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != lead + (n,) + trail:
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                             f"expected {lead + (n,) + trail}")
        if x.device != mp_desc.device:
            raise ValueError(f"{fn}: {name} is on {x.device}, not {mp_desc.device}")
        if not x.is_contiguous():
            x = x.contiguous()
        if x.data_ptr() % align:
            x = x.clone()
        ins.append(x)
    return ins, lead, (lead[0] if lead else 1), M, N


def _launched(fn, err: int):
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed (cudaError {err})")
    with _count_lock:
        fn.launches += 1


def match_rows(mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct,
               feat_ok, octave_lo: int = 1, octave_hi: int = 1):
    """Row-wise best/second-best masked Hamming match.

    mp_desc (…,M,8) int32, uv (…,M,2) f32, rad (…,M) f32, lvl (…,M) int32,
    row_ok (…,M) bool; feat_desc (…,N,8) int32, feat_xy (…,N,2) f32,
    feat_oct (…,N) int32, feat_ok (…,N) bool; "…" is an optional batch
    dimension T shared by all arguments.
    Returns idx, best, second, each (…,M) int32 (BIG where no candidate),
    views of one (3,…,M) buffer.
    """
    tensors = (mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct, feat_ok)
    if mp_desc.device.type == "cpu":
        return match_rows_reference(*tensors, octave_lo, octave_hi)
    ins, lead, T, M, N = _prepare("match_rows", tensors)
    out = torch.empty((3,) + lead + (M,), dtype=torch.int32, device=mp_desc.device)
    stream = torch.cuda.current_stream(mp_desc.device).cuda_stream
    err = _load().match_rows_launch(*[t.data_ptr() for t in ins], out.data_ptr(),
                                    T, M, N, int(octave_lo), int(octave_hi), stream)
    _launched(match_rows, err)
    return tuple(out.unbind(0))


def match_rows_dual(mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct,
                    feat_ok, octave_lo: int = 1, octave_hi: int = 1, wide: float = 2.0):
    """:func:`match_rows` at the radii ``rad`` and ``wide * rad`` in one
    launch. Returns ``((idx, best, second), (idx_w, best_w, second_w))``,
    views of one (2,3,…,M) buffer; each triple equals, bit for bit, a
    single-radius call at that radius."""
    tensors = (mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct, feat_ok)
    if mp_desc.device.type == "cpu":
        return match_rows_dual_reference(*tensors, octave_lo, octave_hi, wide)
    ins, lead, T, M, N = _prepare("match_rows_dual", tensors)
    out = torch.empty((2, 3) + lead + (M,), dtype=torch.int32, device=mp_desc.device)
    stream = torch.cuda.current_stream(mp_desc.device).cuda_stream
    err = _load().match_rows_dual_launch(*[t.data_ptr() for t in ins], out.data_ptr(),
                                         T, M, N, int(octave_lo), int(octave_hi),
                                         float(wide), stream)
    _launched(match_rows_dual, err)
    narrow, wider = out.unbind(0)
    return tuple(narrow.unbind(0)), tuple(wider.unbind(0))


match_rows.launches = 0
match_rows_dual.launches = 0
