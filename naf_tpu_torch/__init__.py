"""naf_tpu_torch: the device half of naf_tpu on PyTorch and CUDA.

The port runs the device FASTA round trip of ``naf_tpu`` on one NVIDIA
H100: encode (``parallel.pipeline.encode_device``: fused classify/emit
kernel, 4-bit pack, host stitching into the NAF container) and decode
(``pipeline.decoder.fasta_device``: 4-bit unpack, mask parity, record
layout).  Its kernels are CUDA C++ under ``csrc/``, built with nvcc at first
use (``native/build.py``).  Every kernel wrapper also has a plain PyTorch
version that runs when it is given CPU tensors; the tests hold both against
the JAX package.

The host stack (``naf_tpu.format``, ``codec``, ``native``, ``pipeline``,
``ops.tables``, ``ops.mask``, ``ops.render``, ``parallel.decode.build_plan``)
is imported from ``naf_tpu`` as it is; none of it imports jax.  The port
never imports jax.
"""

from . import zstd_compat

zstd_compat.install()
