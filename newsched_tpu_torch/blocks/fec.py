"""FEC blocks (reference: newsched_tpu/blocks/fec.py, GNU Radio's gr-fec CC
encoder/decoder pair): a convolutional encoder, the Viterbi decoder (S3 on
the card, ops/fec.py) and block interleavers. Streams carry hard bits
(ri16 0/1) on the encoder side and soft metrics (rf32 LLRs, positive = 1
more likely) into the decoder.

Packetized contract: the stream is segmented into fixed ``frame_bits``
message frames, each independently terminated (K-1 flush bits), which
keeps every shape static per batch. Rates are exact rationals so the
graph compiler's rate algebra sizes batches correctly: encoder out/in =
n*(frame+K-1)/frame, decoder the inverse.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from newsched_tpu_torch.ops import fec as fec_ops
from newsched_tpu_torch.runtime.block import Block


class cc_encoder(Block):
    """Rate-1/n convolutional encoder over frames of frame_bits bits."""

    def __init__(self, frame_bits: int = 512, polys=fec_ops.CC_K7_POLYS,
                 K: int = 7, name=None):
        super().__init__(name)
        self.frame_bits = int(frame_bits)
        self.polys = tuple(polys)
        self.K = int(K)
        n = len(self.polys)
        self.coded_per_frame = (self.frame_bits + self.K - 1) * n
        self.add_input("in", "ri16")
        self.add_output("out", "ri16")
        self.relative_rate = Fraction(self.coded_per_frame, self.frame_bits)
        self._gen: dict = {}

    def work(self, state, ins, params, nout):
        bits = ins["in"].reshape(-1, self.frame_bits)
        if bits.device not in self._gen:
            self._gen[bits.device] = fec_ops.poly_matrix(self.polys, self.K,
                                                         bits.device)
        coded = fec_ops.conv_encode(bits, self.polys, self.K, terminate=True,
                                    gen=self._gen[bits.device])
        return state, {"out": coded.reshape(-1).to(torch.int16)}


class cc_decoder(Block):
    """Viterbi decoder consuming rf32 LLRs (positive = bit 1); emits the
    decoded frame_bits message bits per frame."""

    def __init__(self, frame_bits: int = 512, polys=fec_ops.CC_K7_POLYS,
                 K: int = 7, name=None):
        super().__init__(name)
        self.frame_bits = int(frame_bits)
        self.polys = tuple(polys)
        self.K = int(K)
        n = len(self.polys)
        self.coded_per_frame = (self.frame_bits + self.K - 1) * n
        self.add_input("in", "rf32")
        self.add_output("out", "ri16")
        self.relative_rate = Fraction(self.frame_bits, self.coded_per_frame)
        self._tables: dict = {}

    def work(self, state, ins, params, nout):
        llr = ins["in"].reshape(-1, self.coded_per_frame)
        if llr.device not in self._tables:
            self._tables[llr.device] = fec_ops.viterbi_tables(
                self.polys, self.K, llr.device)
        bits = fec_ops.viterbi_decode(llr, self.polys, self.K, terminated=True,
                                      tables=self._tables[llr.device])
        return state, {"out": bits.reshape(-1).to(torch.int16)}


class interleaver(Block):
    """Block interleaver over fixed frames (write rows, read columns)."""

    def __init__(self, frame: int, rows: int, dtype="rf32", inverse: bool = False,
                 name=None):
        super().__init__(name)
        if frame % rows != 0:
            raise ValueError(f"frame {frame} not divisible by rows {rows}")
        self.frame, self.rows, self.inverse = int(frame), int(rows), bool(inverse)
        self.add_input("in", dtype)
        self.add_output("out", dtype)

    def work(self, state, ins, params, nout):
        x = ins["in"].reshape(-1, self.frame)
        fn = (fec_ops.block_deinterleave if self.inverse
              else fec_ops.block_interleave)
        return state, {"out": fn(x, self.rows).reshape(-1)}


def deinterleaver(frame: int, rows: int, dtype="rf32", name=None) -> interleaver:
    return interleaver(frame, rows, dtype=dtype, inverse=True, name=name)
