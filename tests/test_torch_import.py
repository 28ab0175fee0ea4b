"""The port runs where JAX is absent: importing every module of
orbslam3_tpu_torch (the loop closer, vocabulary, Sim3 and pose-graph modules
among them, the settings loader, the PNG reader, the viewer and the frame
step of ``entry``) and the example drivers ``examples/run_*_torch.py``,
extracting one frame and building a loop closer on the packaged vocabulary
must never import ``jax``, the JAX package ``orbslam3_tpu``, ``cv2``,
``matplotlib``, ``yaml`` or ``PIL`` (the machine with the GPU has none of
them), and no file of the port, of its drivers or of chip_smoke.py
reads a file of that package: what the port shares with it
(``csrc/mapops.cpp``, ``data/vocab_synth.npz``) is a copy, held byte-equal
here."""
import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import glob, importlib, importlib.abc, os, pkgutil, sys
import numpy as np

# the machine with the card has no JAX, no OpenCV, no matplotlib, no PyYAML
# and no Pillow
BLOCKED = ("jax", "jaxlib", "orbslam3_tpu", "cv2", "matplotlib", "yaml", "PIL")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import orbslam3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(orbslam3_tpu_torch.__path__,
                                                "orbslam3_tpu_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("utils.config", "utils.imageio", "utils.serialization", "models.viewer", "entry"):
    assert "orbslam3_tpu_torch." + n in names, n
# the example drivers
sys.path.insert(0, "examples")
drivers = sorted(glob.glob("examples/run_*_torch.py"))
assert len(drivers) == 6, drivers
for path in drivers:
    importlib.import_module(os.path.basename(path)[:-3])

import torch
torch.set_num_threads(2)
from orbslam3_tpu_torch.ops import features
from orbslam3_tpu_torch.utils.datasets import RoomScene, orbit_trajectory
scene = RoomScene(seed=1)
R, t = orbit_trajectory(2)[0]
f = features.extract_orb(torch.from_numpy(scene.render(R, t)),
                         features.OrbConfig(n_features=256))
assert int(f.valid.sum()) > 100
from orbslam3_tpu_torch.models import loop_closing
from orbslam3_tpu_torch.models.map import MapConfig, MapState
for n in ("ops.vocab", "ops.sim3", "ops.posegraph", "models.loop_closing", "ops.imu",
          "ops.imu_init", "ops.vi_ba"):
    assert "orbslam3_tpu_torch." + n in names, n
lc = loop_closing.LoopCloser(MapState(MapConfig(n_features=256)),
                             np.array([458.0, 457.0, 376.0, 240.0], np.float32),
                             (752, 480), device="cpu")
assert lc.vocab.n_words == 10000, lc.vocab.n_words
assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
print("OK", len(names))
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n_modules = int(res.stdout.split()[-1])
    assert n_modules >= 32


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


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for fn in sorted(os.listdir(os.path.join(REPO, "examples"))):
        if fn.endswith("_torch.py"):
            yield os.path.join(REPO, "examples", fn)
    for root, _, files in os.walk(os.path.join(REPO, "orbslam3_tpu_torch")):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)


def _strings_outside_docstrings(tree):
    """Every string constant of a module except its docstrings (prose may
    name the reference's files; code may not build a path to them)."""
    doc = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    getattr(body[0], "value", None), ast.Constant):
                doc.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in doc):
            yield node


def test_no_string_resolves_into_the_jax_package():
    """No string in the port's code is the JAX package's directory name (a
    component to join a path from) or names a file or directory that exists
    under ``orbslam3_tpu/`` when joined to the repository root, the port's
    directory or the file's own. (The kernels' ``replaces`` notes carry a
    ``file:line`` and name no file.)"""
    ref = os.path.realpath(os.path.join(REPO, "orbslam3_tpu"))
    bad, n_strings = [], 0
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in _strings_outside_docstrings(tree):
            n_strings += 1
            hit = node.value.strip("/\\") == "orbslam3_tpu"
            for base in (REPO, os.path.dirname(path), os.path.join(REPO, "orbslam3_tpu_torch")):
                if hit or "\0" in node.value or len(node.value) > 512:
                    break
                full = os.path.realpath(os.path.join(base, node.value))
                hit = (full + os.sep).startswith(ref + os.sep) and os.path.exists(full)
            if hit:
                bad.append(f"{path}:{node.lineno}: {node.value!r}")
    assert n_strings > 500, "the walk must have seen the port's strings"
    assert not bad, bad


def test_mapops_source_is_the_ports_own_copy():
    """The native map operations build from the port's own source, and that
    copy has not drifted from the reference's."""
    from orbslam3_tpu_torch import native
    own = os.path.join(REPO, "orbslam3_tpu_torch", "csrc", "mapops.cpp")
    assert os.path.realpath(native._SRC) == os.path.realpath(own)
    assert os.path.realpath(native._SO).startswith(
        os.path.realpath(os.path.join(REPO, "orbslam3_tpu_torch", "build")) + os.sep)
    with open(own, "rb") as a, open(os.path.join(REPO, "orbslam3_tpu", "native",
                                                  "mapops.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_vocabulary_is_the_ports_own_copy():
    """The default vocabulary loads from the port's own data directory, and
    that copy has not drifted from the reference's."""
    from orbslam3_tpu_torch.models import loop_closing
    own = os.path.join(REPO, "orbslam3_tpu_torch", "data", "vocab_synth.npz")
    assert os.path.realpath(os.path.join(loop_closing._DATA_DIR, "vocab_synth.npz")) == \
        os.path.realpath(own)
    with open(own, "rb") as a, open(os.path.join(REPO, "orbslam3_tpu", "data",
                                                  "vocab_synth.npz"), "rb") as b:
        assert a.read() == b.read()
