"""chip_smoke.py's kernel and multidevice phases alone, on the card(s).

    python3 scripts/multidevice_phase.py [--no-kernel] [--profile]

Builds the kernel, holds both match_rows entries exact against their plain
versions at every shape of the kernel phase (the multi-stream frontend's
T=4 batch among them, with its device time), then runs
``chip_smoke.phase_multidevice``: the landmark-sharded solver on 4 logical
shards of the first card against the single-device local BA and against the
same solve on the CPU, the mapper's sharded global BA, both again on a mesh
of every visible card when there are two or more, the 4-stream frontend at
752x480 against the single-stream frame step, and ``dryrun_multichip(4)``.
Prints the card, each part's seconds and the phase's record as JSON; any
failed check raises. ``--profile`` first traces one sharded solve (4 logical
shards of the first card) and one single-device local BA of the phase's
256-keyframe problem with ``torch.profiler`` and prints each one's operators
by device time and by host time, and its launch count.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_solves(cs, torch):
    """Operators of one sharded solve and one single-device solve, warm."""
    from torch.profiler import ProfilerActivity, profile
    prob = cs.sharded_loop_problem(cs.MD_KF, cs.MD_PTS)
    card = torch.device("cuda", 0)
    runs = {"sharded (4 logical shards)": lambda: cs.sharded_solve(prob, [card] * cs.MD_SHARDS),
            "single-device local_ba": lambda: cs.single_device_ba(prob, card)}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        n_launch = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                        "cudaLaunchKernelExC"))
        dev_us = sum(e.self_device_time_total for e in ev)
        print(f"profile {name}: {n_launch} kernel launches, device time "
              f"{dev_us / 1e3:.2f} ms", flush=True)
        print(ev.table(sort_by="self_device_time_total", row_limit=12), flush=True)
        print(ev.table(sort_by="self_cpu_time_total", row_limit=12), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-kernel", action="store_true", help="skip the kernel phase")
    ap.add_argument("--profile", action="store_true",
                    help="trace the sharded and the single-device solve first")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("multidevice_phase: no CUDA device")
    print(cs.card_line(), flush=True)
    print(f"cards: {torch.cuda.device_count()}", flush=True)
    print(f"build: {cs.mr.build(verbose=False):.2f} s nvcc", flush=True)
    out = {}
    if args.profile:
        profile_solves(cs, torch)
    if not args.no_kernel:
        t = time.perf_counter()
        rec = cs.phase_kernel()
        out["kernel_s"] = time.perf_counter() - t
        out["kernel_T4"] = {k: v["shapes"][(4096, 1024, cs.MD_STREAMS)] for k, v in rec.items()}
    t = time.perf_counter()
    out["multidevice"] = cs.phase_multidevice()
    out["multidevice_s"] = time.perf_counter() - t
    print(f"multidevice: {out['multidevice_s']:.1f} s")
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
