"""simple_hrnet_tpu_torch — the PyTorch/CUDA port of simple_hrnet_tpu.

Multi-person 2D pose estimation (YOLOv3 or YOLOv5 -> HRNet or PoseResNet)
on an NVIDIA GPU, with hand-written CUDA kernels (``csrc/``) for the
detectors' NMS, HRNet's branch-0 BasicBlock chain and its high-resolution
fusion. Imports PyTorch,
never JAX or the JAX package.
"""

from simple_hrnet_tpu_torch.api import SimpleHRNet

__all__ = ['SimpleHRNet']
