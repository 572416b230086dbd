"""S3 ``viterbi_decode``: add-compare-select and traceback of a rate-1/n
convolutional code, frame by frame (reference: newsched_tpu/ops/fec.py
``viterbi_decode``, its ACS ``lax.scan`` at ``:131`` and its traceback at
``:142``). No TPU kernel: the reference runs both as scans, which torch
cannot express, so the decoder is a CUDA kernel here (``csrc/viterbi.cu``),
with its plain PyTorch version beside it: a torch loop over the steps,
every frame and state at once. The kernel has two instances, chosen by
the number of states S = 2^(K-1) and the rate 1/n (``viterbi_plan``): up
to K = 9 (``WARP_MAX_K``) at n <= 4 a frame a warp, S/32 states a lane, a
step in shuffles and one redux with no barrier (``launches``); past K = 9,
or past n = 4, a frame a block of up to 1024 threads, S/1024 states a
thread past K = 11, one barrier a step (``block_launches``). Either keeps
a frame's LLRs and decision words in shared memory where they fit, and
past that in device memory (``global_launches`` counts those launches, of
either instance): any frame length is taken. Up to K = 15
(``SMEM_MAX_K``) the block instance keeps a frame's two rows of metrics
in shared memory; past it in device memory too (``metric_launches``), so
any K is taken whose metrics and decision words fit the card's memory.

The trellis tables come from ops/fec.py (``viterbi_tables``: the
reference's ``pred``/``pbit`` loop and its expected branch symbols; it
asserts the butterfly both instances read the predecessors from). On
CPU tensors the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, and refuses frames whose metrics and
decision words pass the card's memory with a ValueError naming the bytes
(ROADMAP.md Queue 3, R2). The decoded bits equal the reference's
bit for bit at rate 1/2: each branch metric is a sum of two exact +-r
products, and the kernel rounds each add as the plain version does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from newsched_tpu_torch.ops.cuda import _build

SMEM_MAX_K = 15      # S = 2^(K-1) <= 16384: two rows of metrics, 128 KB,
# the last code whose metrics a block's shared memory holds
MAX_K = 27           # the kernel's int indexing: S <= 2^26
CARD_BYTES = 80 * 2**30  # the H100's memory: what a meta tensor plans against
WARP_MAX_K = 9       # the warp instance's codes: S <= 256, 8 states a lane
WARP_MAX_N = 4       # coded bits a step the warp instance's registers hold
SMEM_MAX = 232448    # shared memory a block on the H100 (227 KB)
NEG = -1e9           # metric of the states the encoder cannot start in


class ViterbiTables(NamedTuple):
    """One code's trellis on a device: for each state s', its two
    predecessors ``pred`` (S, 2) int32, their input bits ``pbit`` (S, 2)
    int32 and the expected +-1 symbols on the two branches ``psym``
    (S, 2, n) float32."""

    pred: torch.Tensor
    pbit: torch.Tensor
    psym: torch.Tensor


def viterbi_smem(T: int, n: int, S: int, instance: str = "block",
                 memory: str = "shared") -> int:
    """Shared memory of a frame (``csrc/viterbi.cu``). The block instance:
    two rows of metrics and of warp maxima, and, staged ("shared"), the
    frame's LLRs, its decision words (S/32 a step, one below 32 states)
    and its bits. The warp instance: staged, the frame's LLRs (then its
    bits) and its decision words; "global", nothing."""
    nw = max(1, S // 32)
    staged = memory == "shared"
    if instance == "warp":
        return 4 * T * (n + nw) if staged else 0
    metrics = 2 * S if S <= 1 << (SMEM_MAX_K - 1) else 0
    return 4 * (metrics + 64 + (T * n + T * nw + T if staged else 0))


def viterbi_device_bytes(frames: int, T: int, K: int) -> int:
    """Device memory of the global route's scratch for ``frames`` frames of
    T steps: the decision words (T max(1, S/32) a frame) and, past K =
    ``SMEM_MAX_K``, the two rows of metrics (2 S floats a frame)."""
    S = 1 << (K - 1)
    words = T * max(1, S // 32)
    metrics = 2 * S if K > SMEM_MAX_K else 0
    return 4 * frames * (words + metrics)


def viterbi_plan(T: int, n: int, K: int, frames: int = 1,
                 card_bytes: int | None = None) -> tuple[str, str]:
    """(instance, memory) of S3 for frames of T steps of a rate-1/n code
    of constraint length K: "warp" at K <= 9 and n <= 4, else "block";
    "shared" where the frame's LLRs and decision words (and its metrics,
    up to K = 15) fit a block's shared memory, else "global" (always past
    K = 15, whose metrics are in device memory). ``card_bytes``: the
    card's memory; the global route's scratch for ``frames`` frames
    (``viterbi_device_bytes``) past it raises, naming the bytes."""
    if K > MAX_K:
        raise ValueError(f"viterbi_decode: K = {K}: 2^{K - 1} states pass "
                         f"the kernel's indexing (K <= {MAX_K})")
    inst = viterbi_instance(K, n)
    fits = (K <= SMEM_MAX_K
            and viterbi_smem(T, n, 1 << (K - 1), inst) <= SMEM_MAX)
    memory = "shared" if fits else "global"
    need = viterbi_device_bytes(frames, T, K) if memory == "global" else 0
    if card_bytes is not None and need > card_bytes:
        raise ValueError(f"viterbi_decode: {frames} frames of {T} steps at "
                         f"K = {K} need {need} B of device memory for their "
                         f"decision words{' and metrics' if K > SMEM_MAX_K else ''}"
                         f", past the card's {card_bytes} B (ROADMAP.md "
                         f"Queue 3, R2)")
    return inst, memory


def viterbi_frames_plain(llr: torch.Tensor, tables: ViterbiTables,
                         terminated: bool, nbits: int) -> torch.Tensor:
    """The plain version: llr (F, T, n) float32 -> (F, nbits) int32, the
    first ``nbits`` of each frame's traced-back bits."""
    F, T, n = llr.shape
    pred, pbit, psym = tables
    S = pred.shape[0]
    dev = llr.device
    metrics = torch.full((F, S), NEG, dtype=torch.float32, device=dev)
    metrics[:, 0] = 0.0
    choices = torch.empty((T, F, S), dtype=torch.int64, device=dev)
    for t in range(T):
        rt = llr[:, t]                              # (F, n)
        bm = psym[None, :, :, 0] * rt[:, None, None, 0]
        for j in range(1, n):
            bm = bm + psym[None, :, :, j] * rt[:, None, None, j]
        cand = metrics[:, pred] + bm                # (F, S, 2)
        ch = cand[..., 1] > cand[..., 0]            # argmax: the first max
        new = torch.where(ch, cand[..., 1], cand[..., 0])
        metrics = new - new.max(dim=1, keepdim=True).values
        choices[t] = ch.to(torch.int64)
    if terminated:
        state = torch.zeros(F, dtype=torch.int64, device=dev)
    else:
        state = torch.argmax(metrics, dim=1)
    bits = torch.empty((F, T), dtype=torch.int32, device=dev)
    pred64, pbit32 = pred.to(torch.int64), pbit.to(torch.int32)
    for t in range(T - 1, -1, -1):
        which = choices[t].gather(1, state[:, None])[:, 0]
        bits[:, t] = pbit32[state, which]
        state = pred64[state, which]
    return bits[:, :nbits]


def viterbi_instance(K: int, n: int = 2) -> str:
    """The kernel's instance for a rate-1/n code of constraint length K."""
    return "warp" if K <= WARP_MAX_K and n <= WARP_MAX_N else "block"


def viterbi_frames(llr: torch.Tensor, tables: ViterbiTables, K: int,
                   terminated: bool) -> torch.Tensor:
    """S3 on (F, T, n) float32 LLRs: the plain version for a CPU tensor,
    ``viterbi_launch`` for a CUDA tensor (its route ``viterbi_plan(T, n,
    K)``). Returns (F, T - (K-1)) int32 bits for a terminated code, else
    (F, T)."""
    F, T, n = llr.shape
    nbits = T - (K - 1) if terminated else T
    if llr.device.type == "cpu":
        return viterbi_frames_plain(llr, tables, terminated, nbits)
    S = int(tables.psym.shape[0])
    dev = llr.device
    card = (torch.cuda.get_device_properties(dev).total_memory
            if dev.type == "cuda" else CARD_BYTES)
    inst, memory = viterbi_plan(T, n, K, F, card)
    if S != 1 << (K - 1):
        raise ValueError(f"viterbi_decode: tables of {S} states for K = {K}")
    lib = _build.lib()  # raises where the kernels cannot be built
    _build.check_tensor(llr, "llr", device=dev, shape=(F, T, n))
    _build.check_tensor(tables.psym, "psym", device=dev, shape=(S, 2, n))
    bits = torch.empty((F, nbits), dtype=torch.int32, device=dev)
    dec = (torch.empty(F * T * max(1, S // 32), dtype=torch.int32, device=dev)
           if memory == "global" else None)
    metrics = (torch.empty(F * 2 * S, dtype=torch.float32, device=dev)
               if K > SMEM_MAX_K else None)
    with torch.cuda.device(dev):
        err = lib.viterbi_launch(
            llr.data_ptr(), bits.data_ptr(), tables.psym.data_ptr(),
            None if dec is None else dec.data_ptr(),
            None if metrics is None else metrics.data_ptr(), F, T, n, S,
            int(terminated), nbits, int(inst == "warp"),
            int(memory == "global"), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "viterbi_launch")
    if inst == "warp":
        viterbi_frames.launches += 1
    else:
        viterbi_frames.block_launches += 1
    if memory == "global":
        viterbi_frames.global_launches += 1
    if metrics is not None:
        viterbi_frames.metric_launches += 1
    return bits


viterbi_frames.launches = 0
viterbi_frames.block_launches = 0
viterbi_frames.global_launches = 0
viterbi_frames.metric_launches = 0
