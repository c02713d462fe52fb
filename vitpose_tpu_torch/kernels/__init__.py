"""Build and loading of the port's hand-written CUDA kernels (csrc/)."""
