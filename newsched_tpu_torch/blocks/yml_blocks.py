"""Blocks built from the shipped YAML descriptors at import (reference:
newsched_tpu/blocks/yml_blocks.py; GNU Radio's per-block .yml compiled by
its blockbuilder, SURVEY.md §3.5). The descriptors live in blocks/yml/,
their ``expr:`` kernels in torch, and runtime/blockspec.py turns them into
Block classes. Importing this module needs PyYAML; importing
``newsched_tpu_torch.blocks`` does not import it.

    from newsched_tpu_torch.blocks import yml_blocks
    blk = yml_blocks.multiply_const_y(k=2.0)
"""

from __future__ import annotations

import os

from newsched_tpu_torch.runtime.blockspec import load_module

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "yml")

_CLASSES = load_module(_DIR)
globals().update(_CLASSES)

__all__ = sorted(_CLASSES)
