"""The block library (reference: newsched_tpu/blocks)."""

from newsched_tpu_torch.blocks import (  # noqa: F401
    analog, digital, fec, fft, filter, general, math, streamops,
    vector_dsp)
