"""Forward error correction: convolutional encode and Viterbi decode
(reference: newsched_tpu/ops/fec.py; GNU Radio's gr-fec CC encoder/decoder
pair).

- **Encoder**: a rate-1/n feedforward convolutional code is a sliding
  window of GF(2) dot products: (N, K) bit windows against the polynomial
  bit matrix, the parity of an exact int32 product-sum (torch has no
  integer matmul on CUDA, and nothing here goes through a lossy type).
- **Viterbi**: add-compare-select over 2^(K-1) states and a traceback,
  frame by frame: S3 (ops/cuda/fec.py, ``csrc/viterbi.cu``) on the card,
  its plain torch version on the CPU. Soft-decision (LLR) or hard-decision
  (``hard_to_llr``) metrics.

Streaming: blocks of bits are decoded independently with explicit
zero-flush termination per block (``conv_encode(..., terminate=True)``),
the standard packetized-CC contract.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import fec as _k

# The classic K=7 rate-1/2 code (Voyager / 802.11 / CCSDS), octal 171/133.
CC_K7_POLYS = (0o171, 0o133)


def _poly_bits(polys: tuple[int, ...], K: int) -> np.ndarray:
    """(n_out, K) 0/1 matrix; row r = taps of generator r, MSB = oldest bit
    convention: output_r[t] = parity(poly_r & window(bits[t-K+1 .. t]))."""
    out = np.zeros((len(polys), K), dtype=np.int32)
    for r, p in enumerate(polys):
        for k in range(K):
            out[r, K - 1 - k] = (p >> k) & 1
    return out


def poly_matrix(polys: tuple[int, ...], K: int, device) -> torch.Tensor:
    """``_poly_bits`` as an int32 tensor on ``device`` (a block keeps one,
    so a captured step uploads nothing)."""
    return torch.as_tensor(_poly_bits(tuple(polys), K), device=device)


def conv_encode(bits, polys: tuple[int, ...] = CC_K7_POLYS, K: int = 7,
                terminate: bool = True,
                gen: torch.Tensor | None = None) -> torch.Tensor:
    """Encode hard bits (0/1 int) with a rate-1/n convolutional code.

    ``bits`` (..., N): each row is encoded on its own. ``gen``:
    ``poly_matrix(polys, K, bits.device)``, built here if not given.
    Returns interleaved coded bits [out0[0], out1[0], out0[1], ...],
    (len + (K-1 if terminate else 0)) * n a row, int32."""
    b = torch.as_tensor(bits).to(torch.int32)
    G = poly_matrix(polys, K, b.device) if gen is None else gen  # (n, K)
    pad_tail = K - 1 if terminate else 0
    # K-1 zeros of encoder reset state in front; optional flush tail.
    bp = torch.nn.functional.pad(b, (K - 1, pad_tail))
    W = bp.unfold(-1, K, 1)  # (..., N, K) windows, oldest..newest
    coded = (W[..., None, :] * G).sum(-1, dtype=torch.int32) % 2  # (..., N, n)
    return coded.reshape(*b.shape[:-1], -1)


def _trellis(polys: tuple[int, ...], K: int):
    """Transition tables for 2^(K-1) states. State = last K-1 input bits,
    newest in the LSB. next_state[s, b], out_bits[s, b] -> (n,) coded."""
    G = _poly_bits(polys, K)
    S = 1 << (K - 1)
    n = G.shape[0]
    nxt = np.zeros((S, 2), dtype=np.int32)
    out = np.zeros((S, 2, n), dtype=np.int32)
    for s in range(S):
        for b in (0, 1):
            # window (oldest..newest) = bits of s (old high) then b
            window = [(s >> (K - 2 - i)) & 1 for i in range(K - 1)] + [b]
            out[s, b] = np.mod(G @ np.array(window), 2)
            nxt[s, b] = ((s << 1) | b) & (S - 1)
    return nxt, out


@functools.lru_cache(maxsize=None)
def _tables_np(polys: tuple[int, ...], K: int):
    """The predecessor formulation of the trellis: for each new state s',
    its two predecessors and the input bit that got there (the reference's
    loop), and the expected +-1 symbols on its two incoming branches."""
    nxt, out = _trellis(polys, K)
    S = nxt.shape[0]
    pred = np.zeros((S, 2), dtype=np.int32)
    pbit = np.zeros((S, 2), dtype=np.int32)
    cnt = np.zeros(S, dtype=np.int32)
    for s in range(S):
        for b in (0, 1):
            sp = nxt[s, b]
            pred[sp, cnt[sp]] = s
            pbit[sp, cnt[sp]] = b
            cnt[sp] += 1
    psym = np.stack([(2 * out[pred[sp], pbit[sp]] - 1).astype(np.float32)
                     for sp in range(S)])  # (S, 2, n)
    return pred, pbit, psym


def check_butterfly(pred: np.ndarray, pbit: np.ndarray) -> None:
    """Raise unless the tables are the shift register's butterfly that S3's
    kernels read instead of them: state s' has the predecessors s'>>1 and
    (s'>>1) + S/2, in that order, both by the input bit s' & 1 (so states
    2p and 2p + 1 share their two predecessors)."""
    S = pred.shape[0]
    s = np.arange(S)
    want = np.stack([s >> 1, (s >> 1) + S // 2], axis=1)
    if not (np.array_equal(pred, want)
            and np.array_equal(pbit, np.stack([s & 1, s & 1], axis=1))):
        raise ValueError("viterbi_tables: the trellis is not the shift "
                         "register's butterfly (pred[s] = s>>1, s>>1 + S/2; "
                         "pbit[s] = s & 1) that S3's kernels assume")


def viterbi_tables(polys: tuple[int, ...], K: int, device) -> _k.ViterbiTables:
    """The trellis tables of one code on ``device``, checked to be the
    butterfly (``check_butterfly``)."""
    pred, pbit, psym = _tables_np(tuple(polys), int(K))
    check_butterfly(pred, pbit)
    return _k.ViterbiTables(*(torch.tensor(a, device=device)  # a copy
                              for a in (pred, pbit, psym)))


def viterbi_decode(llr: torch.Tensor, polys: tuple[int, ...] = CC_K7_POLYS,
                   K: int = 7, terminated: bool = True,
                   tables: _k.ViterbiTables | None = None) -> torch.Tensor:
    """Maximum-likelihood sequence decode.

    Args:
      llr: (n_steps * n,) soft metrics of one frame, or (frames,
        n_steps * n), positive = bit more likely 1 (hard bits map via
        ``2*bit - 1``). n = len(polys).
      terminated: the encoder appended K-1 flush zeros (conv_encode
        default); they are stripped from the returned bits.
      tables: ``viterbi_tables(polys, K, llr.device)``, built here if not
        given (a block builds them once).

    Returns (n_msg,) or (frames, n_msg) int32 decoded bits."""
    n = len(polys)
    r = torch.as_tensor(llr).to(torch.float32)
    frames = r.reshape(-1, r.shape[-1] // n, n).contiguous()
    if tables is None:
        tables = viterbi_tables(polys, K, r.device)
    bits = _k.viterbi_frames(frames, tables, int(K), terminated)
    return bits.reshape(*r.shape[:-1], bits.shape[-1])


def hard_to_llr(coded_bits) -> torch.Tensor:
    """Hard 0/1 coded bits -> +-1 pseudo-LLRs for viterbi_decode."""
    return 2.0 * torch.as_tensor(coded_bits).to(torch.float32) - 1.0


def block_interleave(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Classic block interleaver: write row-wise, read column-wise, along
    the last axis. Its length must divide by rows."""
    n = int(x.shape[-1])
    if n % rows != 0:
        raise ValueError(f"length {n} not divisible by rows {rows}")
    lead = x.shape[:-1]
    return x.reshape(*lead, rows, n // rows).transpose(-1, -2).reshape(*lead, n)


def block_deinterleave(x: torch.Tensor, rows: int) -> torch.Tensor:
    n = int(x.shape[-1])
    if n % rows != 0:
        raise ValueError(f"length {n} not divisible by rows {rows}")
    lead = x.shape[:-1]
    return x.reshape(*lead, n // rows, rows).transpose(-1, -2).reshape(*lead, n)
