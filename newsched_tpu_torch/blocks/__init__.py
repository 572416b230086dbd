"""The block library (reference: newsched_tpu/blocks).

``zmq``, ``audio``, ``soapy``, ``gui`` and ``yml_blocks`` are imported by
name; none is needed to import this package (it needs neither pyzmq nor
PyYAML)."""

from newsched_tpu_torch.blocks import (  # noqa: F401
    analog, digital, fec, fft, fileio, filter, general, math, network,
    streamops, vector_dsp)
