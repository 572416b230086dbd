"""Prebuilt flagship flowgraphs (reference: newsched_tpu/models)."""

from newsched_tpu_torch.models.qpsk import (qpsk_constellation,  # noqa: F401
                                            qpsk_receiver, qpsk_tx, rrc_taps)
from newsched_tpu_torch.models.wbfm import (fir_chain,  # noqa: F401
                                            fm_channelizer,
                                            make_fm_demod_hier, wbfm_receiver)
