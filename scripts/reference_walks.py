"""Reference runs of chip_smoke.py's system phases on the CPU.

    python3 scripts/reference_walks.py --package jax|torch --phase slice|headline
        [--frames N] [--mapping sync|async] [--pipeline 0|1]

Drives the very functions chip_smoke.py drives on the GPU (``run_walk``,
``run_reloc``) with the JAX package ``orbslam3_tpu`` or with the port on the
CPU, at the same full-size configuration (752x480, 1024 features):

- ``slice``: 60 frames of the walk with sync mapping, then the
  relocalization scenario on that system (textureless frames, walk resumed);
- ``headline``: 300 frames with ``mapping_mode="async"`` and
  ``TrackingParams(pipeline=True)``; ``--mapping`` and ``--pipeline`` override
  either, to tell the mapper thread's share from the pipeline's.

chip_smoke.py's bounds come from the JAX runs: ATE at most
max(1.5 x JAX, JAX + 0.02), and the number of frames within which the state
must be back to OK. Times printed here are CPU times and say nothing about
the GPU. Prints one line per phase and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def jax_classes() -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from orbslam3_tpu.models.system import SlamSystem
    from orbslam3_tpu.models.tracking import TrackingParams
    return dict(system_cls=SlamSystem, params_cls=TrackingParams)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--phase", choices=("slice", "headline"), required=True)
    ap.add_argument("--frames", type=int, default=0, help="0: the phase's own length")
    ap.add_argument("--mapping", choices=("sync", "async"), default=None)
    ap.add_argument("--pipeline", type=int, choices=(0, 1), default=None)
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    opt = ap.parse_args()
    import torch
    torch.set_num_threads(opt.threads)
    import chip_smoke as cs
    kw = jax_classes() if opt.package == "jax" else {"device": "cpu"}
    mapping = opt.mapping or ("sync" if opt.phase == "slice" else "async")
    pipeline = bool(opt.phase == "headline" if opt.pipeline is None else opt.pipeline)
    out = {"package": opt.package, "phase": opt.phase, "device": "cpu",
           "mapping": mapping, "pipeline": pipeline}
    name = f"{opt.package} on the CPU, {opt.phase} ({mapping}, pipeline {pipeline})"
    if opt.phase == "slice":
        n = opt.frames or cs.SLICE_FRAMES
        scene, poses, imgs = cs.render_walk(n + cs.RELOC_BLANK + cs.RELOC_RESUME)
        slam, rec = cs.run_walk(scene, poses, imgs, n, mapping, pipeline, **kw)
        print(cs.walk_line(name, n, rec))
        reloc = cs.run_reloc(slam, scene, imgs, n)
        print(f"{opt.package} on the CPU, reloc: {json.dumps(reloc)}")
        out.update(walk=rec, reloc=reloc)
    else:
        n = opt.frames or cs.HEADLINE_FRAMES
        scene, poses, imgs = cs.render_walk(n)
        slam, rec = cs.run_walk(scene, poses, imgs, n, mapping, pipeline, **kw)
        print(cs.walk_line(name, n, rec))
        out.update(walk=rec)
    slam.shutdown(print_times=False)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
