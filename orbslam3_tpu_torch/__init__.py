"""orbslam3_tpu_torch — the PyTorch + CUDA port of ``orbslam3_tpu``.

Same layout and module names as the JAX package (``ops/``, ``models/``,
``utils/``, ``native/``), written as plain functions on tensors. Every tensor
lives on the device that ``SlamSystem(..., device=...)`` names, and that is
the CUDA card unless the caller names another (``device=None`` → ``cuda``; no
entry point falls back to the CPU, see :func:`resolve_device`). The
hand-written Hopper kernels (``ops/match_rows.py`` + ``csrc/match_rows.cu``)
run for CUDA tensors, their plain PyTorch versions for CPU tensors.

This package imports neither ``jax`` nor ``orbslam3_tpu``: the host-only
numpy modules it shares with the reference are copies.
"""

__version__ = "0.1.0"

# SLAM geometry (pose LM, triangulation, Schur BA) is numerically fragile: a
# reduced-precision matmul pass corrupts normal equations and projection
# chains (the JAX package measured it as a tracking failure under bf16 TPU
# passes). On Hopper the same hazard is TF32, on by default for cuDNN and
# selectable for matmuls — keep every float32 product in full float32.
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> "_torch.device":
    """The device an entry point runs on: ``None`` means the CUDA card and
    raises when there is none; anything else is taken as given. Nothing falls
    back to the CPU: a CPU run is one the caller asked for by name."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "orbslam3_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device=\"cpu\" to run on the CPU")
        return _torch.device("cuda")
    return _torch.device(device)
