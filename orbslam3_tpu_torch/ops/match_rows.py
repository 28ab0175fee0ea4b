"""Masked windowed Hamming top-2 per row: the Hopper port of the Pallas
``orbslam3_tpu/ops/matching_pallas.py::match_rows``.

``match_rows`` launches the CUDA kernel in ``csrc/match_rows.cu`` for CUDA
tensors and runs :func:`match_rows_reference`, the plain PyTorch version of
the same function, for CPU tensors. A CUDA tensor never takes the plain path:
the kernel runs or the call raises.

The kernel builds at first use from the repository's source with ``nvcc``
into ``orbslam3_tpu_torch/build/`` and is bound through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import time

import torch

from .matching import BIG, hamming_matrix

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "match_rows.cu")
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libmatch_rows.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build(verbose: bool = False) -> float:
    """Compile the kernel into ``LIBRARY`` if it is missing or older than its
    source; returns the seconds spent compiling (0.0 when up to date)."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        if verbose and res.stderr:
            print(res.stderr.strip())
        os.replace(tmp, LIBRARY)   # atomic: a concurrent process never loads half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            vp = ctypes.c_void_p
            ci = ctypes.c_int
            lib.match_rows_launch.argtypes = [vp] * 12 + [ci] * 5 + [vp]
            lib.match_rows_launch.restype = ci
            _lib = lib
    return _lib


def match_rows_reference(mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy,
                         feat_oct, feat_ok, octave_lo: int = 1, octave_hi: int = 1):
    """Plain PyTorch version: Hamming matrix, masks, ``argmin`` (lowest column
    among ties) and the second best over the other columns. Accepts an
    optional leading batch dimension on every argument."""
    dist = hamming_matrix(mp_desc, feat_desc)                     # (…,M,N)
    du = torch.abs(uv[..., :, None, 0] - feat_xy[..., None, :, 0])
    dv = torch.abs(uv[..., :, None, 1] - feat_xy[..., None, :, 1])
    r = rad[..., :, None]
    doct = feat_oct[..., None, :] - lvl[..., :, None]
    mask = ((du <= r) & (dv <= r) & (doct >= -octave_lo) & (doct <= octave_hi)
            & row_ok[..., :, None] & feat_ok[..., None, :])
    d = torch.where(mask, dist, BIG)
    idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, idx[..., None])[..., 0]
    col = torch.arange(d.shape[-1], device=d.device)
    second = torch.amin(torch.where(col == idx[..., None], BIG, d), dim=-1)
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"match_rows: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"match_rows: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")


def match_rows(mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct,
               feat_ok, octave_lo: int = 1, octave_hi: int = 1):
    """Row-wise best/second-best masked Hamming match.

    mp_desc (…,M,8) int32, uv (…,M,2) f32, rad (…,M) f32, lvl (…,M) int32,
    row_ok (…,M) bool; feat_desc (…,N,8) int32, feat_xy (…,N,2) f32,
    feat_oct (…,N) int32, feat_ok (…,N) bool; "…" is an optional batch
    dimension T shared by all arguments.
    Returns idx, best, second, each (…,M) int32 (BIG where no candidate).
    """
    if mp_desc.device.type == "cpu":
        return match_rows_reference(mp_desc, uv, rad, lvl, row_ok, feat_desc,
                                    feat_xy, feat_oct, feat_ok, octave_lo, octave_hi)
    if mp_desc.device.type != "cuda":
        raise RuntimeError(f"match_rows: no kernel for device {mp_desc.device}")
    batched = mp_desc.dim() == 3
    lead = tuple(mp_desc.shape[:-2])
    T = mp_desc.shape[0] if batched else 1
    M, N = mp_desc.shape[-2], feat_desc.shape[-2]
    args = [("mp_desc", mp_desc, torch.int32, lead + (M, 8)),
            ("uv", uv, torch.float32, lead + (M, 2)),
            ("rad", rad, torch.float32, lead + (M,)),
            ("lvl", lvl, torch.int32, lead + (M,)),
            ("row_ok", row_ok, torch.bool, lead + (M,)),
            ("feat_desc", feat_desc, torch.int32, lead + (N, 8)),
            ("feat_xy", feat_xy, torch.float32, lead + (N, 2)),
            ("feat_oct", feat_oct, torch.int32, lead + (N,)),
            ("feat_ok", feat_ok, torch.bool, lead + (N,))]
    ins = []
    for name, x, dtype, shape in args:
        _check(name, x, dtype, shape)
        if x.device != mp_desc.device:
            raise ValueError(f"match_rows: {name} is on {x.device}, not {mp_desc.device}")
        ins.append(x.contiguous())
    if N < 1:
        raise ValueError("match_rows: needs at least one feature column")
    outs = [torch.empty(lead + (M,), dtype=torch.int32, device=mp_desc.device)
            for _ in range(3)]
    lib = _load()
    stream = torch.cuda.current_stream(mp_desc.device).cuda_stream
    err = lib.match_rows_launch(*[t.data_ptr() for t in ins + outs],
                                T, M, N, int(octave_lo), int(octave_hi), stream)
    if err != 0:
        raise RuntimeError(f"match_rows: kernel launch failed (cudaError {err})")
    match_rows.launches += 1
    return outs[0], outs[1], outs[2]


match_rows.launches = 0
