"""Hand-written Hopper kernels (CUDA C++ in `../csrc`) with their plain
PyTorch versions; `ops` is the device-dispatched entry point."""
