"""naf_tpu_torch: the device half of naf_tpu on PyTorch and CUDA.

The port runs the device FASTA and FASTQ round trips of ``naf_tpu`` on one
NVIDIA H100: encode (``parallel.pipeline.encode_device``: fused
classify/emit kernel, 4-bit pack, host stitching into the NAF container)
and decode (``pipeline.decoder.fasta_device`` and ``fastq_device``: 4-bit
unpack, mask parity, record layout).  Its kernels are CUDA C++ under
``csrc/``, built with nvcc at first use (``native/build.py``).  Every kernel
wrapper also has a plain PyTorch version that runs when it is given CPU
tensors; the tests hold both against the JAX package.

The port has its own copy of the host stack it runs on (``format``,
``codec``, ``native``, ``pipeline``, the numpy helpers under ``ops``), so it
imports nothing of ``naf_tpu``, and never imports jax.  Importing it changes
no other module: where the ``zstandard`` package is missing, its codec
calls the system libzstd itself (``zstd_compat``).
"""
