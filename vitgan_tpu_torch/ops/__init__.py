"""Hand-written CUDA kernels for Hopper, their plain versions and routing."""
