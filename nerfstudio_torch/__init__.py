"""nerfstudio_torch — the PyTorch/CUDA port of nerfstudio_tpu.

Module paths and names mirror ``nerfstudio_tpu`` so each module's JAX
counterpart is easy to find. The package imports ``torch`` and never ``jax``;
its hand-written CUDA kernels live in ``csrc/`` and build at first CUDA use.
"""
