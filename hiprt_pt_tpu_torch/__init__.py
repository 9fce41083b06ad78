"""hiprt_pt_tpu_torch — the PyTorch/CUDA port of ``hiprt_pt_tpu``.

Same subpackage layout and module names as the JAX package, so each module's
counterpart is easy to find. Imports torch and numpy, never JAX. The BVH
traversal runs through hand-written CUDA kernels (csrc/traverse.cu) on CUDA
tensors and through a plain PyTorch walk on CPU tensors.
"""
