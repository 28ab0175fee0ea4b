"""Device time of the match_rows kernels on one NVIDIA GPU, variants in turns.

    python3 scripts/match_rows_device_time.py [--parent-source OLD.cu]
        [--rows-per-warp 1,2] [--warps-per-block 4,8] [--sass FILE]

Builds ``orbslam3_tpu_torch/csrc/match_rows.cu`` once per requested
``MR_ROWS_PER_WARP`` x ``MR_WARPS_PER_BLOCK`` (and, with ``--parent-source``, an earlier version of
the kernel whose C entry point takes three output pointers), checks each
build against the plain PyTorch version, and times them at the tracking
path's shapes (4096x1024 and 1024x1024) in the order parent, variants,
variants, parent. A time is the device's: 200 back-to-back launches of the C
entry point with pre-resolved pointers, captured in a CUDA graph and replayed
(``chip_smoke.graph_ms``), so the host cannot be the limit. It also reads the
kernels' own durations from ``torch.profiler`` where the profiler reports
device time. Prints one line per variant and shape, then one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from orbslam3_tpu_torch.ops import match_rows as mr  # noqa: E402

SHAPES = ((4096, 1024), (1024, 1024))


def bind_parent(library: str):
    """The earlier kernel: nine inputs, three output pointers, one radius."""
    lib = ctypes.CDLL(library)
    lib.match_rows_launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.match_rows_launch.restype = ctypes.c_int
    return lib


def parent_launcher(lib, args, out):
    M, N = args[0].shape[0], args[5].shape[0]
    ptrs = [t.data_ptr() for t in args] + [out[i].data_ptr() for i in range(3)]
    return lambda stream: lib.match_rows_launch(*ptrs, 1, M, N, 1, 1, stream)


def profiler_us(launch, names, iters: int = 50):
    """Mean device microseconds per kernel by name from torch.profiler, or
    None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    stream = torch.cuda.current_stream().cuda_stream
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            launch(stream)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = getattr(ev, "cuda_time_total", 0.0)
            if total and ev.count:
                return float(total) / ev.count
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-source", default=None)
    ap.add_argument("--rows-per-warp", default="1,2,4")
    ap.add_argument("--warps-per-block", default="8",
                    help="MR_WARPS_PER_BLOCK values, comma separated")
    ap.add_argument("--sass", default=None, metavar="FILE",
                    help="write the first variant's SASS (cuobjdump) to FILE")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: kernel times come only from the GPU")
    print(cs.card_line())
    print(f"sm clock max {cs.sm_clock_hz() / 1e6:.0f} MHz, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    rows = [int(v) for v in opt.rows_per_warp.split(",")]
    builds = {}
    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = {}
        for r, w in [(r, int(w)) for r in rows for w in opt.warps_per_block.split(",")]:
            lib = os.path.join(mr.BUILD_DIR, f"libmatch_rows_r{r}_w{w}.so")
            flags = (f"-DMR_ROWS_PER_WARP={r}", f"-DMR_WARPS_PER_BLOCK={w}")
            futs[f"rows{r} warps{w}"] = (
                lib, pool.submit(mr.compile_source, mr.SOURCE, lib, flags, True))
        if opt.parent_source:
            lib = os.path.join(mr.BUILD_DIR, "libmatch_rows_parent.so")
            futs["parent"] = (lib, pool.submit(mr.compile_source, opt.parent_source, lib, (),
                                               True))
        for name, (lib, fut) in futs.items():
            print(f"build {name}: {fut.result():.2f} s nvcc")
            builds[name] = bind_parent(lib) if name == "parent" else mr.bind(lib)

    if opt.sass:
        dump = cs.subprocess.run(
            [os.path.join(os.path.dirname(mr.nvcc_path()), "cuobjdump"), "-sass",
             os.path.join(mr.BUILD_DIR,
                          f"libmatch_rows_r{rows[0]}_w{opt.warps_per_block.split(',')[0]}.so")],
            capture_output=True, text=True)
        os.makedirs(os.path.dirname(os.path.abspath(opt.sass)), exist_ok=True)
        with open(opt.sass, "w") as fh:
            fh.write(dump.stdout + dump.stderr)

    rng = np.random.default_rng(7)
    result = {}
    for (M, N) in SHAPES:
        args = cs.match_inputs(rng, M, N)
        want1 = mr.match_rows_reference(*args)
        want2 = mr.match_rows_dual_reference(*args)
        out3 = torch.empty((3, M), dtype=torch.int32, device="cuda")
        out6 = torch.empty((6, M), dtype=torch.int32, device="cuda")
        launchers = {}
        for name, lib in builds.items():
            if name == "parent":
                launchers[name] = (parent_launcher(lib, args, out3), out3, want1)
            else:
                launchers[name + " single"] = (
                    cs.c_launcher(lib, "match_rows", args, out3), out3, want1)
                launchers[name + " dual"] = (
                    cs.c_launcher(lib, "match_rows_dual", args, out6, 2.0), out6,
                    want2[0] + want2[1])
        stream = torch.cuda.current_stream().cuda_stream
        for name, (launch, out, want) in launchers.items():
            out.fill_(-7)
            err = launch(stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{name}: launch failed (cudaError {err})")
            for i, w in enumerate(want):
                if not torch.equal(out[i], w):
                    raise AssertionError(f"{name} M={M} N={N}: output plane {i} differs on "
                                         f"{int((out[i] != w).sum())} rows")
        order = list(launchers)
        order = order + order[::-1]                 # parent, variants, variants, parent
        times = {name: [] for name in launchers}
        for name in order:
            times[name].append(cs.graph_ms(launchers[name][0]) * 1e3)
        clk = cs.subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                 "--format=csv,noheader"], capture_output=True,
                                text=True).stdout.strip()
        print(f"M={M} N={N} sm clock right after the timed replays: {clk}")
        for name, (launch, _, _) in launchers.items():
            prof = profiler_us(launch, ("match_rows_kernel",))
            t = times[name]
            prof_txt = "not measured" if prof is None else f"{prof:.2f} us"
            print(f"M={M} N={N} {name}: exact; device {t[0]:.2f}/{t[1]:.2f} us per launch "
                  f"(graph of 200); profiler {prof_txt}")
            result[f"{M}x{N} {name}"] = dict(graph_us=t, profiler_us=prof)
        b1, by1, surv1 = cs.match_bound_ms(args, 1.0, 3 * M)
        b2, by2, surv2 = cs.match_bound_ms(args, 2.0, 6 * M)
        print(f"M={M} N={N} bound: single {b1 * 1e3:.2f} us ({by1}, {surv1} pairs in a "
              f"window), dual {b2 * 1e3:.2f} us ({by2}, {surv2} pairs)")
        result[f"{M}x{N} bound_us"] = dict(single=b1 * 1e3, dual=b2 * 1e3)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
