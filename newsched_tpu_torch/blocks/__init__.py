"""The block library (reference: newsched_tpu/blocks)."""

from newsched_tpu_torch.blocks import general, vector_dsp  # noqa: F401
