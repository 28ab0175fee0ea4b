"""Train a binary vocabulary from rendered-scene ORB descriptors with the
PyTorch port: the counterpart of scripts/train_vocab.py, with the same
arguments and the same corpus, that needs no JAX.

bit_pattern_31 ORB descriptors are extracted on the CUDA card (``--device``,
default the card; ``--device cpu`` runs on the CPU) from rendered viewpoints
across several scene seeds; the tree is hierarchical k-medians (k=10, L
levels: 4 → 10k words) and the tf-idf weights come from a corpus pass
(DBoW2 TemplatedVocabulary::create and setNodeWeights). The written ``.npz``
loads with ``BinaryVocabulary.load`` and goes to the port's ``LoopCloser``
as its ``vocab``.

    python scripts/train_vocab_torch.py [OUT] [--levels 4] [--scenes 6] [--images 20]
    python scripts/train_vocab_torch.py /tmp/v.npz --levels 2 --scenes 1 --images 4 --device cpu
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from orbslam3_tpu_torch import resolve_device  # noqa: E402
from orbslam3_tpu_torch.ops import features as feat_ops  # noqa: E402
from orbslam3_tpu_torch.ops.vocab import BinaryVocabulary  # noqa: E402
from orbslam3_tpu_torch.utils.datasets import RoomScene  # noqa: E402

H, W = 240, 376


def corpus_images(n_scenes: int, imgs_per_scene: int):
    """The training views of scripts/train_vocab.py, in its order and from
    its seeded draws: per scene seed, random camera centres and yaws in the
    room, each render jittered in exposure and noise. Yields (scene seed,
    float32 image)."""
    rng = np.random.default_rng(0)
    for seed in range(n_scenes):
        scene = RoomScene(seed=seed, h=H, w=W, fx=229.3, fy=228.6,
                          cx=188.0, cy=120.0, n_clutter=5)
        for _ in range(imgs_per_scene):
            c = np.array([rng.uniform(-2.5, 2.5), rng.uniform(-1.2, 1.2),
                          rng.uniform(0.5, 4.0)])
            yaw = rng.uniform(-0.6, 0.6)
            cy_, sy = np.cos(yaw), np.sin(yaw)
            R_wc = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
            R = R_wc.T
            img = scene.render(R, -R @ c)
            # exposure/blur jitter: a descriptor corpus from clean renders
            # under-represents the intensity-noise modes real imagery has
            img = img * rng.uniform(0.7, 1.3) + rng.normal(0, 3.0, img.shape)
            yield seed, img.astype(np.float32)


def train(out_path, levels: int = 4, n_scenes: int = 6, imgs_per_scene: int = 20,
          device=None):
    """Extract the corpus on ``device``, train, weight and save. Returns
    (vocabulary, per-image descriptors as (n, 8) int32 numpy arrays, the
    per-image word ids that the idf pass counted)."""
    dev = resolve_device(device)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    extract = feat_ops.make_extractor(H, W, feat_ops.OrbConfig(n_features=512), device=dev)
    all_desc = []
    t0 = time.time()
    last_seed = 0
    for seed, img in corpus_images(n_scenes, imgs_per_scene):
        if seed != last_seed:
            print(f"scene {last_seed}: {sum(len(d) for d in all_desc)} descriptors "
                  f"({time.time() - t0:.0f}s)", flush=True)
            last_seed = seed
        f = extract(torch.as_tensor(img, device=dev))
        all_desc.append(f.desc[f.valid].cpu().numpy())
    print(f"scene {last_seed}: {sum(len(d) for d in all_desc)} descriptors "
          f"({time.time() - t0:.0f}s)", flush=True)
    desc = np.concatenate(all_desc)
    print("training on", len(desc), "descriptors")
    vocab = BinaryVocabulary(k=10, levels=levels).train(desc.view(np.uint32), seed=1)
    print(f"trained {vocab.n_words} words ({time.time() - t0:.0f}s)")

    # corpus pass for idf, on the card
    tf = vocab.transform_fn(device=dev)
    word_arrays = []
    for d in all_desc:
        words = tf(torch.as_tensor(d, device=dev), torch.ones(len(d), dtype=torch.bool,
                                                              device=dev))
        word_arrays.append(words.cpu().numpy())
    vocab.compute_idf(word_arrays)
    used = (vocab.idf < np.log(len(word_arrays))).sum()
    print(f"idf: {used}/{vocab.n_words} words seen in corpus")
    vocab.save(out_path)
    print("saved", out_path)
    return vocab, all_desc, word_arrays


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None,
                    help="the .npz to write (default: the port's packaged vocabulary)")
    ap.add_argument("--levels", type=int, default=4,
                    help="tree depth (k=10): 4 -> 10k words, 5 -> 100k")
    ap.add_argument("--scenes", type=int, default=6)
    ap.add_argument("--images", type=int, default=20,
                    help="images per scene (100k words wants >=40 scenes x 30)")
    ap.add_argument("--device", default=None,
                    help="where to extract and transform (default: the CUDA card)")
    a = ap.parse_args(argv)
    out = a.out or os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "orbslam3_tpu_torch", "data", "vocab_synth.npz")
    return train(out, levels=a.levels, n_scenes=a.scenes, imgs_per_scene=a.images,
                 device=a.device)


if __name__ == "__main__":
    main()
