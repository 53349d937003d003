"""ccrs_tpu_torch — the PyTorch/CUDA port of ``ccrs_tpu``.

A second package beside the JAX reference: the same camera-intrinsic
calibration system (AprilGrid detection, UCM/EUCM models, RANSAC + PnP
initialization, Schur-structured Levenberg–Marquardt bundle adjustment),
written as plain torch functions on tensors and run on an NVIDIA Hopper
GPU.  The detector's adaptive threshold runs as a hand-written CUDA kernel
(``csrc/threshold.cu``, bound in ``ops/threshold_cuda.py``); every other
stage is torch code that runs on whatever device its input tensors live on.

The package never imports jax or ``ccrs_tpu``: framework-free modules are
copied, and the tag-family table is read by file path.

Dtypes are explicit everywhere (no global default is changed): float64
for solver and geometry state, float32 for the image path.
"""

import torch

# Reduced-precision matmuls corrupt the geometry (the JAX package records
# the same lesson for the TPU's bf16 passes), so keep every float32 matmul
# and convolution in full float32 on the GPU.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
