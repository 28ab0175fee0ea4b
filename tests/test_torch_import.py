"""The port runs where JAX is absent: importing every module of
orbslam3_tpu_torch and extracting one frame must never import ``jax`` or the
JAX package ``orbslam3_tpu`` (the machine with the GPU has no JAX)."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys
import numpy as np

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import orbslam3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(orbslam3_tpu_torch.__path__,
                                                "orbslam3_tpu_torch.")]
for n in names:
    importlib.import_module(n)

import torch
torch.set_num_threads(2)
from orbslam3_tpu_torch.ops import features
from orbslam3_tpu_torch.utils.datasets import RoomScene, orbit_trajectory
scene = RoomScene(seed=1)
R, t = orbit_trajectory(2)[0]
f = features.extract_orb(torch.from_numpy(scene.render(R, t)),
                         features.OrbConfig(n_features=256))
assert int(f.valid.sum()) > 100
assert not any(k.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu") for k in sys.modules)
print("OK", len(names))
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n_modules = int(res.stdout.split()[-1])
    assert n_modules >= 25


def test_no_import_line_names_jax():
    pat = re.compile(r"^\s*(import|from) (jax|orbslam3_tpu)\b")
    bad = []
    for root, _, files in os.walk(os.path.join(REPO, "orbslam3_tpu_torch")):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                with open(path) as fh:
                    bad += [f"{path}:{i}" for i, line in enumerate(fh, 1) if pat.match(line)]
    assert not bad, bad
