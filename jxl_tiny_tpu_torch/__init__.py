"""jxl_tiny_tpu_torch: the PyTorch/CUDA port of jxl_tiny_tpu, a JPEG XL
(VarDCT, encode-only) encoder with the capabilities of libjxl-tiny.

Device path: torch tensors on an NVIDIA H100, with hand-written CUDA
kernels (csrc/, built with nvcc at first use) where the JAX package has
Pallas TPU kernels. Host path: entropy-code construction and bitstream
assembly in numpy. The port imports neither jax nor jxl_tiny_tpu; it keeps
its own copies of the host-side modules it needs.
"""
from .encoder import DeviceEncodeJob, encode_image_device  # noqa: F401

__version__ = "0.1.0"
