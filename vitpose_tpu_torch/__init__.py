"""ViTPose-TPU ported to PyTorch and CUDA for NVIDIA Hopper (H100).

A package beside the JAX reference `vitpose_tpu`, with the same layout and
names. It imports torch and numpy, never JAX or the JAX package.

- ``ops``      attention (K1 forward and K2 backward CUDA kernels, the
               differentiable K3, plain versions), crop geometry, batched
               warp, heatmap decoding, training targets, PCK and the host
               keypoint metrics, OKS NMS
- ``models``   ViT backbone (with block remat), classic deconv head and
               simple decoder, top-down estimator, loss
- ``api``      init_pose_model (also from a config file) /
               inference_top_down_pose_model / load_checkpoint
- ``data``     dataset metadata, the COCO index and top-down dataset with
               its evaluation, the host loader (native or cv2 JPEG decode),
               training augmentation and preprocessing
- ``eval``     COCO keypoint AP and the val loop on the device
- ``train``    layer-decay AdamW with freezing, train state, the top-down
               train step, models from a config file's model dict, and the
               config-driven training runner (``train_model``)
- ``parallel`` SIGTERM preemption and the training seed (one process)
- ``tools``    the evaluation and training CLIs
               (``python -m vitpose_tpu_torch.tools.test`` / ``.train``),
               the server, export, webcam and analysis, dataset and misc
               tools, and the torchrun and SLURM launchers
- ``utils``    config files, weight carry-over from the JAX package's
               variables, .pth reading with the pos-embed regrid and
               patch-kernel pad, training checkpoints, threading limits
- ``kernels``  nvcc build and ctypes loading of ``csrc/*.cu`` at first use,
               and the g++ build of the native loader ``csrc/loader.cpp``
- ``csrc``     the hand-written sm_90a CUDA sources and the loader's C++

Entry points run on CUDA unless the caller passes ``device='cpu'``. A CUDA
tensor goes through the kernels (or raises); a CPU tensor goes through their
plain PyTorch versions.
"""

__version__ = "0.1.0"
