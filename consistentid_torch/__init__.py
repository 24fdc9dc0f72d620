"""ConsistentID on PyTorch and CUDA (port of the JAX package, NVIDIA
Hopper). The SD1.5 text-to-image path is in `pipelines`; the hand-written
kernels are in `csrc/` and bound in `ops/`."""
