"""Filter blocks (reference: newsched_tpu/blocks/filter.py): the polyphase
channelizer and the single-channel polyphase decimator."""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from newsched_tpu_torch.ops import firdes, pfb as pfb_ops
from newsched_tpu_torch.runtime.block import Block


class _pfb_block(Block):
    """What the two polyphase blocks share: the arm taps, their constants
    uploaded once per device, and the M*L-1-sample tail state."""

    def __init__(self, nchans: int, taps, name):
        super().__init__(name)
        self.nchans = int(nchans)
        self.taps = np.asarray(taps, dtype=np.float32)
        self.arm_taps = pfb_ops.pfb_arm_taps(self.taps, self.nchans)
        self.relative_rate = Fraction(1, self.nchans)
        self._consts: dict[torch.device, pfb_ops.PfbConsts] = {}

    def consts(self, device) -> pfb_ops.PfbConsts:
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = pfb_ops.pfb_consts(self.arm_taps, device)
        return self._consts[device]

    def init_state(self, nin, nout, device):
        return pfb_ops.pfb_init_state(self.arm_taps.size, device)


class pfb_channelizer(_pfb_block):
    """M-channel polyphase channelizer (reference filter::pfb_channelizer):
    cf32 stream in -> stream of (M,)-vector items at rate 1/M, channel k
    centered at k/M of the input rate. When 2M is a multiple of 128 it runs
    the fused front end kernel (K1 ``arm_fold_dft``) on a GPU."""

    def __init__(self, nchans: int, taps=None, taps_per_arm: int = 16,
                 attenuation_db: float = 80.0, name=None):
        if taps is None:
            taps = firdes.prototype_channelizer_taps(nchans, taps_per_arm,
                                                     attenuation_db)
        super().__init__(nchans, taps, name)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32", item_shape=(self.nchans,))

    def work(self, state, ins, params, nout):
        x = ins["in"]
        st, Y = pfb_ops.pfb_channelize(self.arm_taps, state, x,
                                       consts=self.consts(x.device))
        return st, {"out": Y}


class pfb_decimator(_pfb_block):
    """Single-channel PFB decimator (reference filter::pfb_decimator): the
    fold kernel (K7 ``arm_fold``) and one weighted sum over the arms."""

    def __init__(self, nchans: int, channel: int = 0, taps=None,
                 taps_per_arm: int = 16, name=None):
        if taps is None:
            taps = firdes.prototype_channelizer_taps(nchans, taps_per_arm)
        super().__init__(nchans, taps, name)
        self.channel = int(channel)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")

    def work(self, state, ins, params, nout):
        x = ins["in"]
        st, y = pfb_ops.pfb_decimate(self.arm_taps, state, x, self.channel,
                                     consts=self.consts(x.device))
        return st, {"out": y}
