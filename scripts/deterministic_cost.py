"""What PyTorch's deterministic algorithms cost on chip_smoke.py's loop walk.

    python3 scripts/deterministic_cost.py [--stop-after 10] [--turns 2]

Runs the loop walk of chip_smoke.py's ``loop`` phase (sync mapping, 376x240,
256 features, the system's defaults) on the card until ``--stop-after`` frames
after its first correction, in turns: without deterministic algorithms, with
them, and with them but without their NaN fill of uninitialized memory
(``torch.utils.deterministic.fill_uninitialized_memory = False``). Prints the
card's name and power limit, then one line per run: its mode, seconds, first
correction, map points around it, keyframes, map points and ATE. Equal records
across the deterministic modes say the walk reads no uninitialized memory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODES = {"nondeterministic": (False, True), "deterministic": (True, True),
         "deterministic_nofill": (True, False)}


def run(cs, walk, mode: str, stop_after: int) -> dict:
    import torch
    import torch.utils.deterministic as tud
    det, fill = MODES[mode]
    tud.fill_uninitialized_memory = fill
    torch.use_deterministic_algorithms(det, warn_only=True)
    try:
        slam, r = cs.run_loop_walk(*walk, cs.LOOP_FEATURES, "sync", stop_after=stop_after)
    finally:
        torch.use_deterministic_algorithms(False)
        tud.fill_uninitialized_memory = True
    slam.shutdown(print_times=False)
    return {k: r[k] for k in ("frames", "seconds", "first_correction",
                              "map_points_around_correction", "n_keyframes",
                              "n_map_points", "ate", "loop_edges")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stop-after", type=int, default=10)
    ap.add_argument("--turns", type=int, default=2)
    opt = ap.parse_args()
    import chip_smoke as cs   # sets CUBLAS_WORKSPACE_CONFIG before torch starts
    if not cs.torch.cuda.is_available():
        raise SystemExit("deterministic_cost: no CUDA device")
    print(cs.card_line(), flush=True)
    walk = cs.render_loop_walk(False, cs.LOOP_FRAMES, workers=8)
    order = list(MODES)
    for turn in range(opt.turns):
        for mode in (order if turn % 2 == 0 else order[::-1]):
            print(mode, json.dumps(run(cs, walk, mode, opt.stop_after)), flush=True)


if __name__ == "__main__":
    main()
