"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``), each
beside its plain PyTorch version, and their autograd wrappers."""
