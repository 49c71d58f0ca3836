"""Hand-written Hopper kernels and their wrappers. Each module holds a
kernel's wrapper (CUDA tensors launch the kernel and count the launch in
``<wrapper>.launches``; CPU tensors take the plain version beside it).
The CUDA sources live in ``mxnet_tpu_torch/csrc``; ``_build`` compiles
and loads them at first use."""
