"""Hand-written CUDA kernels, the nvcc build step and their Python wrappers."""
