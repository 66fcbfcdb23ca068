"""Build and load the CUDA kernels (see build.py)."""
