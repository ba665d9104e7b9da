"""montgomery_tpu_torch: the MSM of `montgomery_tpu`, ported to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Imports torch and never jax. Tensors on the CPU run each kernel's plain
PyTorch version; tensors on a CUDA device run the kernels.
"""

__version__ = "0.1.0"
