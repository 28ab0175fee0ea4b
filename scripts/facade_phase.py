"""chip_smoke.py's slice, reloc and facade phases alone, on the card.

    python3 scripts/facade_phase.py

Builds the kernel, renders the walk's first 75 frames, runs the 60-frame
slice (sync mapping, no loop closing) and the relocalization scenario on its
system, then ``chip_smoke.phase_facade`` on that system (save, load,
localization mode, the trajectory writers, the resets, the viewer, a system
from a settings file, the synthetic driver, the multi-start walk and solve).
Prints the card, each part's seconds and the facade's record as JSON; any
failed check raises.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    print(f"build: {cs.mr.build(verbose=False):.2f} s nvcc", flush=True)
    scene, poses, imgs = cs.render_walk(cs.SLICE_FRAMES + cs.RELOC_BLANK + cs.RELOC_RESUME,
                                        workers=min(8, os.cpu_count() or 1))
    t = time.perf_counter()
    slam, r = cs.run_walk(scene, poses, imgs, cs.SLICE_FRAMES, "sync", False,
                          enable_loop_closing=False, device="cuda")
    print(f"slice: tracked {r['tracked']:.3f}, ATE {r['ate']:.4f}, "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    cs.phase_reloc(slam, scene, imgs)
    t = time.perf_counter()
    out = cs.phase_facade(slam, scene, poses, imgs)
    slam.shutdown(print_times=False)
    print(f"facade: {time.perf_counter() - t:.1f} s")
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
