"""Array primitives of the sift and its CUDA kernels."""
