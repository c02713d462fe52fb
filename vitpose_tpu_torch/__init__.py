"""ViTPose-TPU ported to PyTorch and CUDA for NVIDIA Hopper (H100).

A package beside the JAX reference `vitpose_tpu`, with the same layout and
names. It imports torch and numpy, never JAX or the JAX package.

- ``ops``      attention (K1 forward and K2 backward CUDA kernels, the
               differentiable K3, plain versions), crop geometry, batched
               warp, heatmap decoding, training targets, PCK
- ``models``   ViT backbone, classic deconv head, top-down estimator, loss
- ``api``      init_pose_model / inference_top_down_pose_model
- ``data``     dataset metadata, training augmentation and preprocessing
- ``train``    layer-decay AdamW, train state, the top-down train step
- ``utils``    weight carry-over from the JAX package's variables
- ``kernels``  nvcc build and ctypes loading of ``csrc/*.cu`` at first use
- ``csrc``     the hand-written sm_90a CUDA sources

Entry points run on CUDA unless the caller passes ``device='cpu'``. A CUDA
tensor goes through the kernels (or raises); a CPU tensor goes through their
plain PyTorch versions.
"""

__version__ = "0.1.0"
