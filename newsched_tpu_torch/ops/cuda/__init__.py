"""Hand-written CUDA kernels for Hopper (reference:
newsched_tpu/ops/pallas). Each module holds a kernel's wrapper, its plain
PyTorch version and its launch count; the sources are ../../csrc/*.cu,
built by _build.py at first use."""
