"""jxl_tiny_tpu_torch: the PyTorch/CUDA port of jxl_tiny_tpu, a JPEG XL
(VarDCT, encode-only) encoder with the capabilities of libjxl-tiny.

Device path: torch tensors on an NVIDIA H100, with hand-written CUDA
kernels (csrc/, built with nvcc at first use) where the JAX package has
Pallas TPU kernels. Host path: entropy-code construction and bitstream
assembly in numpy, with a native bit packer (cpp/, built with g++ at first
use). The port imports neither jax nor jxl_tiny_tpu; it keeps its own
copies of the host-side modules it needs.

Entry points: encode_image_device (one image), encode_images_device
(pipelined, a generator in input order), encode_batch_device (N
same-sized images in one pair of device programs) and, over the ranks of a
torch.distributed mesh (parallel/), encode_image_device_mesh and
encode_batch_device(mesh=). The verification side: encode_image /
encode_file (the numpy golden model, ref/), encode_image_host_packed (the
analysis on the card, the packing on the host) and the decoder
(decode/, `python -m jxl_tiny_tpu_torch.decode in.jxl out.pfm`).
"""
from .encoder import (  # noqa: F401
    DeviceEncodeJob, encode_batch_device, encode_file, encode_image,
    encode_image_device, encode_image_device_mesh, encode_image_host_packed,
    encode_images_device,
)

__version__ = "0.1.0"
