"""DSP helpers and kernels (reference: newsched_tpu/ops). Filter design is
host-side numpy; the kernels live in ops/cuda/ with their CUDA sources in
csrc/."""

from newsched_tpu_torch.ops import firdes, window  # noqa: F401
