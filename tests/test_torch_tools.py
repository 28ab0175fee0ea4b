"""The repository's two user tools in the PyTorch port, against the JAX
package's, on the CPU: ``scripts/train_vocab_torch.py`` (scripts/train_vocab.py)
and ``scripts/evaluate_ate_torch.py`` (scripts/evaluate_ate.py); and the
state converters' default device.

Tolerances: a vocabulary trained by both packages from the same descriptors
and seed is equal bit for bit (children, idf and the words it gives: the same
numpy training code, integer tree descent); the two ATE tools print the same
text (the same float64 numpy alignment, printed to 6 decimals).
"""
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import vocab as jv
from orbslam3_tpu_torch.ops import vocab as tv
from torch_port_helpers import T, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K4 = np.array([229.3, 228.6, 188.0, 120.0], np.float32)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corpus(n_images=12, per_image=250, seed=0):
    """Per-image seeded descriptors, a fifth of each image's exact duplicates
    of another (repeated words)."""
    out = []
    for i in range(n_images):
        d = jv.random_descriptors(per_image, seed=seed * 100 + i)
        d[1::5] = d[0::5][: len(d[1::5])]
        out.append(d)
    return out


@pytest.mark.parametrize("levels", [2, 3])
def test_training_and_idf_match_the_reference(levels):
    """The tool's training (k=10, seed 1) and corpus pass: the same seeded
    descriptors through both packages' ``train`` + ``transform_fn`` +
    ``compute_idf`` give the same tree, words and weights, bit for bit."""
    corpus = _corpus()
    desc = np.concatenate(corpus)
    a = jv.BinaryVocabulary(k=10, levels=levels).train(desc, seed=1)
    b = tv.BinaryVocabulary(k=10, levels=levels).train(desc, seed=1)
    assert len(a.children) == len(b.children) == levels
    for ca, cb in zip(a.children, b.children):
        assert ca.dtype == cb.dtype == np.uint32
        np.testing.assert_array_equal(cb, ca)
    tf_j, tf_t = a.transform_fn(), b.transform_fn(device="cpu")
    words_j = [np.asarray(tf_j(jnp.asarray(d), jnp.ones(len(d), bool))) for d in corpus]
    words_t = [tf_t(T(d), torch.ones(len(d), dtype=torch.bool)).numpy() for d in corpus]
    for wj, wt in zip(words_j, words_t):
        np.testing.assert_array_equal(wt, wj)
    a.compute_idf(words_j)
    b.compute_idf(words_t)
    assert a.idf.dtype == b.idf.dtype == np.float32
    np.testing.assert_array_equal(b.idf, a.idf)


def test_train_vocab_tool_writes_a_vocabulary_the_loop_closer_loads(tmp_path):
    """``train_vocab_torch.main`` at a tiny size on the CPU: the written file
    loads, holds the tree and weights the tool returned, goes into the port's
    ``LoopCloser``, and gives the corpus the words that the JAX package's
    ``transform_fn`` gives it with the same tree."""
    from orbslam3_tpu_torch.models.loop_closing import LoopCloser
    from orbslam3_tpu_torch.models.map import MapConfig, MapState
    tool = _script("train_vocab_torch")
    out = tmp_path / "vocab.npz"
    vocab, corpus, words = tool.main([str(out), "--levels", "2", "--scenes", "1",
                                      "--images", "3", "--device", "cpu"])
    assert len(corpus) == 3 and all(len(d) > 100 for d in corpus)
    loaded = tv.BinaryVocabulary.load(str(out))
    assert loaded.n_words == 100
    for ca, cb in zip(loaded.children, vocab.children):
        np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(loaded.idf, vocab.idf)
    assert (loaded.idf < np.log(3)).sum() > 0           # words the corpus saw
    lc = LoopCloser(MapState(MapConfig(n_features=512)), K4, (376, 240), vocab=loaded,
                    device="cpu")
    assert lc.vocab.n_words == 100 and lc.bow_t == 100
    ref = jv.BinaryVocabulary.load(str(out))
    tf_j = ref.transform_fn()
    for d, w in zip(corpus, words):
        got = lc.transform(torch.as_tensor(d), torch.ones(len(d), dtype=torch.bool)).numpy()
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(
            got, np.asarray(tf_j(jnp.asarray(d.view(np.uint32)), jnp.ones(len(d), bool))))


ATE_CASES = [(scale, fmt) for fmt in ("tum", "euroc") for scale in (False, True)]


@pytest.fixture(scope="module")
def ate_outputs(tmp_path_factory):
    """Both ATE tools on ``trajectory_tum.txt`` (as the ground truth, in TUM
    or EuRoC form) against a seeded perturbed copy (a similarity transform
    and noise), with and without ``--scale``; all subprocesses at once.
    Returns {(scale, fmt): (JAX tool's stdout, the port's)}."""
    tmp = tmp_path_factory.mktemp("ate")
    traj = np.loadtxt(os.path.join(REPO, "trajectory_tum.txt"))
    rng = np.random.default_rng(7)
    est = traj.copy()
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est[:, 1:4] = 1.7 * traj[:, 1:4] @ R.T + [0.1, -0.2, 0.05] + rng.normal(0, 0.002, (len(traj),
                                                                                       3))
    est[:, 0] += rng.uniform(-0.004, 0.004, len(traj))   # within --max-dt
    np.savetxt(tmp / "est.txt", est, fmt="%.7f")
    gt = {"tum": os.path.join(REPO, "trajectory_tum.txt"), "euroc": str(tmp / "gt.csv")}
    with open(gt["euroc"], "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for row in traj:
            f.write(f"{int(round(row[0] * 1e9))},{row[1]},{row[2]},{row[3]},"
                    f"{row[7]},{row[4]},{row[5]},{row[6]}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for scale, fmt in ATE_CASES:
        args = [gt[fmt], str(tmp / "est.txt")] + (["--scale"] if scale else [])
        # the EuRoC cases also print the verbose fields
        args += ["--verbose"] if fmt == "euroc" else ["--gt-format", "tum"]
        procs[scale, fmt] = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", tool)] + args, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for tool in ("evaluate_ate.py", "evaluate_ate_torch.py")]
    out = {}
    for key, pair in procs.items():
        res = [p.communicate(timeout=300) + (p.returncode,) for p in pair]
        for stdout, stderr, rc in res:
            assert rc == 0, stderr[-2000:]
        out[key] = (res[0][0], res[1][0])
    return out


@pytest.mark.parametrize("scale,fmt", ATE_CASES)
def test_evaluate_ate_tool_matches_the_reference(ate_outputs, scale, fmt):
    jax_out, port_out = ate_outputs[scale, fmt]
    assert port_out == jax_out
    if fmt == "euroc":
        fields = dict(line.rsplit(" ", 1)[0].split(" ", 1) for line in port_out.splitlines()
                      if line.startswith("absolute"))
        assert "absolute_translational_error.rmse" in fields
        assert "compared_pose_pairs 24 pairs" in port_out
        rmse = float(port_out.split("rmse ")[1].split()[0])
        s = float(port_out.split("scale ")[1].split()[0])
    else:
        rmse, s = (float(x) for x in port_out.strip().split(","))
    if scale:
        assert abs(s - 1 / 1.7) < 0.01 and rmse < 0.005, (rmse, s)
    else:
        assert s == 1.0 and rmse > 0.01, (rmse, s)


def test_state_converters_default_to_the_card():
    """``preint_state_from`` and ``tracker_inertial_state_from`` with no
    device put their tensors on the CUDA card, and raise without one; for the
    tracker the default is the destination tracker's device. ``device="cpu"``
    still works."""
    from types import SimpleNamespace
    from orbslam3_tpu_torch.ops.imu import PreintState
    from orbslam3_tpu_torch.utils.convert import preint_state_from, tracker_inertial_state_from
    src = {k: np.zeros((3, 3) if k in ("dR",) else 3, np.float32) for k in PreintState._fields}
    src_tracker = SimpleNamespace(kf_preints={1: src}, preint_since_kf=src, frame_preint=None,
                                  imu_queue=[])
    if torch.cuda.is_available():
        assert preint_state_from(src).dT.device.type == "cuda"
        dst = tracker_inertial_state_from(src_tracker, SimpleNamespace())
        assert dst.kf_preints[1].dT.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            preint_state_from(src)
        with pytest.raises(RuntimeError, match="CUDA"):
            tracker_inertial_state_from(src_tracker, SimpleNamespace())
    assert preint_state_from(src, device="cpu").dT.device.type == "cpu"
    dst = tracker_inertial_state_from(src_tracker, SimpleNamespace(device=torch.device("cpu")))
    assert dst.kf_preints[1].dT.device.type == "cpu"
    assert dst.preint_since_kf.dP.device.type == "cpu" and dst.frame_preint is None
    dst = tracker_inertial_state_from(src_tracker, SimpleNamespace(), device="cpu")
    assert dst.kf_preints[1].dR.device.type == "cpu"
