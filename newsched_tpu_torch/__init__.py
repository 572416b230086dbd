"""newsched_tpu_torch — the PyTorch + CUDA port of newsched_tpu.

The same streaming DSP dataflow framework (flowgraphs of blocks, compiled
once by the rate algebra and stepped one batch at a time), with tensors in
PyTorch and the JAX package's Pallas TPU kernels rewritten as hand-written
CUDA kernels for Hopper (``csrc/``, built with nvcc at first use).

Package layout mirrors ``newsched_tpu`` module for module:
  ops/      DSP helpers (numpy) and the kernels (ops/cuda/ + csrc/)
  runtime/  graph model, compiler, runner
  blocks/   the block library (and its YAML descriptors, blocks/yml/)
  io/       the native double-mapped ring the file and socket blocks use
  models/   prebuilt flagship flowgraphs
  utils/    dtypes, logging, preferences

This package never imports jax or newsched_tpu; only the tests that hold it
against the reference import both.
"""

__version__ = "0.1.0"

from newsched_tpu_torch.runtime.block import Block, Port, SyncBlock, param  # noqa: F401
from newsched_tpu_torch.runtime.graph import Flowgraph, Graph, HierBlock  # noqa: F401
