"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each subpackage's ``ops.py`` holds the wrappers (launch counter, input
checks, the kernel on CUDA tensors, the plain version on CPU tensors);
``build.py`` compiles ``csrc/`` with nvcc at first use."""
