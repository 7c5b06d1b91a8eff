"""ct_icp_torch — continuous-time LiDAR odometry in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).

The PyTorch port of ``ct_icp_tpu``: same modules, same algorithms, same map
layout, so every function here has a counterpart of the same name there.
This package imports ``torch`` and numpy only.

Layout:
  config/      options dataclasses + the driving profile
  core/        SE3/pose math (device f32 torch + host f64 numpy instances)
  ops/         voxel hashing, compaction, 3x3 eigen, descriptors
  kernels/     the CUDA kernels' wrappers, each beside its plain PyTorch
               version; sources in csrc/, built with nvcc at first use
  mapping/     the voxel hash map as device tensors
  icp/         residuals, robust losses, the CT-ICP solver
  odometry/    frame pipeline + the streaming odometry driver
  datasets/    synthetic scenes and the driving corridor

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; with no card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None):
    """The torch device for an entry point: ``DEFAULT_DEVICE`` unless the
    caller names one. Raises when CUDA is asked for and there is no card —
    the port never carries on quietly on the CPU."""
    import torch

    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ct_icp_torch: CUDA device requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain PyTorch path")
    return dev
