"""Prebuilt flagship flowgraphs (reference: newsched_tpu/models)."""

from newsched_tpu_torch.models.wbfm import (fm_channelizer,  # noqa: F401
                                            make_fm_demod_hier, wbfm_receiver)
