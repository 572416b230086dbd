"""Graph model, compiler, and runner (reference: newsched_tpu/runtime)."""

from newsched_tpu_torch.runtime.block import Block, Port, param  # noqa: F401
from newsched_tpu_torch.runtime.graph import Flowgraph, Graph, HierBlock  # noqa: F401
from newsched_tpu_torch.runtime.compile import compile_flowgraph  # noqa: F401
