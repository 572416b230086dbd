"""S3 ``viterbi_decode``: add-compare-select and traceback of a rate-1/n
convolutional code, frame by frame (reference: newsched_tpu/ops/fec.py
``viterbi_decode``, its ACS ``lax.scan`` at ``:131`` and its traceback at
``:142``). No TPU kernel: the reference runs both as scans, which torch
cannot express, so the decoder is a CUDA kernel here (``csrc/viterbi.cu``),
with its plain PyTorch version beside it: a torch loop over the steps,
every frame and state at once. ``viterbi_layout`` picks its instance from
the number of states S = 2^(K-1), the rate 1/n, the frame's T steps and
the frames of the call:

- "warp", K <= 9 (``WARP_MAX_K``) at n <= 4: a frame a warp, S/32 states a
  lane, a step in shuffles and one redux with no barrier (``launches``);
- "block", K = 7-13 past the warp's (K = 7-9 at n = 5-8): a frame a
  block of S/E threads, E = 2-8 consecutive states a thread, its metrics
  in shared memory, one barrier a step, the step's max one redux a warp,
  its branch metrics from a table of the step's 2^n sign patterns
  (``block_launches``);
- "cluster", K = 14-18 (to ``CLUSTER_MAX_K``), and wherever the frames
  leave SMs idle: a frame a thread-block cluster of C <= 8 blocks, its two
  rows of metrics split across their shared memory, each block's new
  metrics pushed through distributed shared memory to the block whose
  pairs read them, one cluster barrier a step (``cluster_launches``);
- "serial", what neither takes (n > 8, K <= 6 at n > 4, K > 18): the
  design before these, a frame a block of up to 1024 threads, S/1024
  states a thread, past K = 15 its metrics in device memory
  (``serial_launches``; ``metric_launches`` where its metrics are there).

Each keeps a frame's LLRs and decision words in shared memory where they
fit and staging them costs the launch no wave of blocks, and otherwise in
device memory (``global_launches`` counts those launches, of any
instance): any frame length is taken.

The trellis tables come from ops/fec.py (``viterbi_tables``: the
reference's ``pred``/``pbit`` loop and its expected branch symbols; it
asserts the butterfly every instance reads the predecessors from). On
CPU tensors the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, and refuses frames whose decision words
(and the serial instance's metrics) pass the card's memory with a
ValueError naming the bytes (ROADMAP.md Queue 3, R2). The decoded bits
equal the reference's bit for bit: each branch metric is a sum of exact
+-r products, and every instance rounds each add as the plain version
does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from newsched_tpu_torch.ops.cuda import _build

SMEM_MAX_K = 15      # S = 2^(K-1) <= 16384: two rows of metrics, 128 KB,
# the last code whose metrics one block's shared memory holds
CLUSTER_MAX_K = 18   # two rows of 2^17 metrics over 8 blocks: 128 KB a block
MAX_K = 27           # the kernel's int indexing: S <= 2^26
CARD_BYTES = 80 * 2**30  # the H100's memory: what a meta tensor plans against
CARD_SMS = 132       # the H100's SMs: what a meta tensor plans against
WARP_MAX_K = 9       # the warp instance's codes: S <= 256, 8 states a lane
WARP_MAX_N = 4       # coded bits a step the warp instance's registers hold
ACS_MAX_N = 8        # coded bits a step of the block and cluster instance
ACS_TAB = 1 << ACS_MAX_N  # a step's branch metrics, one a sign pattern
ACS_AUX = 80 + 10 * 32  # words: the bests, the traceback's ring of 10 steps
ACS_STAGE_LLR = 8192  # a frame's LLRs staged on the global route, at most
ACS_MAX_THREADS = 512  # a frame's block in the block and cluster instance
MAX_CLUSTER = 8      # the portable cluster size
SMEM_MAX = 232448    # shared memory a block on the H100 (227 KB)
SM_SMEM = 233472     # shared memory an SM (228 KB), 1 KB of it a block's
SM_THREADS = 2048    # resident threads an SM
SM_BLOCKS = 32       # resident blocks an SM
NEG = -1e9           # metric of the states the encoder cannot start in


class ViterbiTables(NamedTuple):
    """One code's trellis on a device: for each state s', its two
    predecessors ``pred`` (S, 2) int32, their input bits ``pbit`` (S, 2)
    int32 and the expected +-1 symbols on the two branches ``psym``
    (S, 2, n) float32."""

    pred: torch.Tensor
    pbit: torch.Tensor
    psym: torch.Tensor


class ViterbiLayout(NamedTuple):
    """S3's launch for a call: the instance ("warp", "block", "cluster",
    "serial"), where a frame's LLRs and decision words live ("shared" or
    "global"), states a thread ``E`` and blocks a frame ``C`` (the block
    and cluster instance; 0 for the others), threads a block, and shared
    bytes a block."""

    instance: str
    memory: str
    E: int
    C: int
    threads: int
    smem: int


def viterbi_smem(T: int, n: int, S: int, instance: str = "block",
                 memory: str = "shared", E: int | None = None,
                 C: int = 1) -> int:
    """Shared memory of a block (``csrc/viterbi.cu``). The block and
    cluster instance: two rows of S/C metrics, two steps' tables of
    branch metrics, two tables of the frame's warp maxima, the bests and
    the traceback's ring (``ACS_AUX`` words), the frame's LLRs where they
    are staged (on "global" up to ``ACS_STAGE_LLR``), and, staged
    ("shared"), its decision words (S/32 a step) and its bits; E states a
    thread (``acs_states_a_thread`` where None). The serial instance: two rows of
    metrics (none past K = 15) and of warp maxima, and, staged, the same
    three. The warp instance: staged, the frame's LLRs (then its bits) and
    its decision words; "global", nothing."""
    nw = max(1, S // 32)
    staged = memory == "shared"
    if instance == "warp":
        return 4 * T * (n + nw) if staged else 0
    frame = T * n + T * nw + T if staged else 0
    if instance == "serial":
        metrics = 2 * S if S <= 1 << (SMEM_MAX_K - 1) else 0
        return 4 * (metrics + 64 + frame)
    Sb = S // C
    E = E or acs_states_a_thread(Sb, C > 1)
    if not staged and T * n <= ACS_STAGE_LLR:  # the LLRs alone
        frame = T * n
    return 4 * (2 * Sb + 2 * ACS_TAB + 2 * C * (Sb // E // 32) + ACS_AUX
                + frame)


def acs_states_a_thread(Sb: int, cluster: bool = False) -> int:
    """States a thread of the block and cluster instance for Sb states a
    block: one warp below 256 states (E = Sb/32: 2, 4), else 8 in a block
    and, in a cluster, 16 from 2048 states a block (whose stores then
    cross the cluster in fewer, wider pieces), at most ``ACS_MAX_THREADS``
    threads (16, 32)."""
    if Sb < 256:
        return max(2, Sb // 32)
    return max(16 if cluster and Sb >= 2048 else 8, Sb // ACS_MAX_THREADS)


def viterbi_device_bytes(frames: int, T: int, K: int,
                         metrics: bool | None = None) -> int:
    """Device memory of the global route's scratch for ``frames`` frames of
    T steps: the decision words (T max(1, S/32) a frame) and, where the
    serial instance keeps them there (past K = ``CLUSTER_MAX_K``, or
    ``metrics``), the two rows of metrics (2 S floats a frame)."""
    S = 1 << (K - 1)
    words = T * max(1, S // 32)
    if metrics is None:
        metrics = K > CLUSTER_MAX_K
    return 4 * frames * (words + (2 * S if metrics else 0))


def _waves(frames: int, blocks_a_frame: int, threads: int, smem: int,
           sms: int) -> int:
    """Waves of blocks a launch takes: frames x blocks_a_frame blocks, as
    many an SM as its threads, block slots and shared memory allow."""
    per_sm = min(SM_THREADS // threads, SM_BLOCKS, SM_SMEM // (smem + 1024))
    if per_sm < 1:
        return 1 << 30
    return -(-frames * blocks_a_frame // (sms * per_sm))


def viterbi_layout(T: int, n: int, K: int, frames: int = 1,
                   sms: int = CARD_SMS) -> ViterbiLayout:
    """S3's instance, memory and geometry for ``frames`` frames of T steps
    of a rate-1/n code of constraint length K on a card of ``sms`` SMs.
    The warp instance at K <= 9 and n <= 4; the block and cluster instance
    at K = 7-18 and n <= 8, with C the fewest blocks a frame that hold its
    metrics within ``ACS_MAX_THREADS`` threads (8 states a thread in one
    block, up to K = 13; 16 in a cluster, 32 at K = 18), doubled while the
    frames leave SMs idle and a block keeps 4 warps (up to
    ``MAX_CLUSTER``); the serial instance for the rest. The frame's LLRs
    and decision words are staged in shared memory ("shared", C = 1) where
    they fit and the launch takes no more waves of blocks for it, else
    "global" (``acs_layout``)."""
    if K > MAX_K:
        raise ValueError(f"viterbi_decode: K = {K}: 2^{K - 1} states pass "
                         f"the kernel's indexing (K <= {MAX_K})")
    S = 1 << (K - 1)
    inst = viterbi_instance(K, n)
    if inst == "warp":
        staged = viterbi_smem(T, n, S, "warp")
        memory = "shared" if staged <= SMEM_MAX else "global"
        return ViterbiLayout("warp", memory, max(1, S // 32), 0, 0,
                             viterbi_smem(T, n, S, "warp", memory))
    if inst == "serial":
        fits = (K <= SMEM_MAX_K
                and viterbi_smem(T, n, S, "serial") <= SMEM_MAX)
        memory = "shared" if fits else "global"
        return ViterbiLayout("serial", memory, 0, 0, max(32, min(S, 1024)),
                             viterbi_smem(T, n, S, "serial", memory))
    C = 1  # the fewest blocks that hold the metrics: 8 states a thread in
    # one block, 16 in a cluster
    while C < MAX_CLUSTER and (
            S // C > ACS_MAX_THREADS * (8 if C == 1 else 16)
            or viterbi_smem(T, n, S, "block", "global", C=C) > SMEM_MAX):
        C *= 2
    # then more while the frames leave SMs idle, down to 4 warps a block
    while C < MAX_CLUSTER and frames * C <= sms and S // C >= 2048:
        C *= 2
    return acs_layout(T, n, K, acs_states_a_thread(S // C, C > 1), C,
                      frames, sms)


def acs_layout(T: int, n: int, K: int, E: int, C: int, frames: int = 1,
               sms: int = CARD_SMS) -> ViterbiLayout:
    """The block and cluster instance's launch at E states a thread and C
    blocks a frame (``viterbi_layout``'s choice, or another geometry a
    probe times; the bits do not change): its threads, and the frame's
    LLRs and decision words staged ("shared", C = 1) where they fit and
    the launch takes no more waves of blocks for it, else "global".
    Raises ValueError for a geometry the kernel does not take."""
    S = 1 << (K - 1)
    threads = S // C // E
    if (C not in (1, 2, 4, 8) or E not in (2, 4, 8, 16, 32)
            or (C > 1 and E < 8) or threads % 32 or threads < 32
            or threads > ACS_MAX_THREADS):
        raise ValueError(f"viterbi_decode: no block geometry of {E} states "
                         f"a thread and {C} blocks a frame at K = {K}")
    glob = viterbi_smem(T, n, S, "block", "global", E, C)
    memory = "global"
    if C == 1:
        staged = viterbi_smem(T, n, S, "block", "shared", E)
        if staged <= SMEM_MAX and (_waves(frames, 1, threads, staged, sms)
                                   <= _waves(frames, 1, threads, glob, sms)):
            memory = "shared"
    return ViterbiLayout("block" if C == 1 else "cluster", memory, E, C,
                         threads, viterbi_smem(T, n, S, "block", memory, E, C))


def viterbi_plan(T: int, n: int, K: int, frames: int = 1,
                 card_bytes: int | None = None,
                 sms: int = CARD_SMS) -> tuple[str, str]:
    """(instance, memory) of S3 for ``frames`` frames of T steps of a
    rate-1/n code of constraint length K (``viterbi_layout``).
    ``card_bytes``: the card's memory; the global route's scratch for the
    frames (``viterbi_device_bytes``) past it raises, naming the bytes."""
    lay = viterbi_layout(T, n, K, frames, sms)
    if card_bytes is not None:
        _check_device_bytes(lay, T, K, frames, card_bytes)
    return lay.instance, lay.memory


def _check_device_bytes(lay: ViterbiLayout, T: int, K: int, frames: int,
                        card_bytes: int) -> None:
    """Raise where the global route's scratch for the frames
    (``viterbi_device_bytes``) passes the card's memory, naming the
    bytes."""
    metrics = lay.instance == "serial" and K > SMEM_MAX_K
    need = (viterbi_device_bytes(frames, T, K, metrics)
            if lay.memory == "global" else 0)
    if need > card_bytes:
        raise ValueError(f"viterbi_decode: {frames} frames of {T} steps at "
                         f"K = {K} need {need} B of device memory for their "
                         f"decision words{' and metrics' if metrics else ''}"
                         f", past the card's {card_bytes} B (ROADMAP.md "
                         f"Queue 3, R2)")


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
    """The kernel's instance for a rate-1/n code of constraint length K,
    before the frames choose between "block" and "cluster": "warp",
    "block" or "serial"."""
    if K <= WARP_MAX_K and n <= WARP_MAX_N:
        return "warp"
    if n > ACS_MAX_N or K < 7 or K > CLUSTER_MAX_K:
        return "serial"
    return "block"


def viterbi_frames(llr: torch.Tensor, tables: ViterbiTables, K: int,
                   terminated: bool) -> torch.Tensor:
    """S3 on (F, T, n) float32 LLRs: the plain version for a CPU tensor,
    the kernel for a CUDA tensor (its launch ``viterbi_layout(T, n, K,
    F)``). Returns (F, T - (K-1)) int32 bits for a terminated code, else
    (F, T)."""
    F, T, n = llr.shape
    nbits = T - (K - 1) if terminated else T
    if llr.device.type == "cpu":
        return viterbi_frames_plain(llr, tables, terminated, nbits)
    S = int(tables.psym.shape[0])
    dev = llr.device
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        card, sms = props.total_memory, props.multi_processor_count
    else:
        card, sms = CARD_BYTES, CARD_SMS
    lay = viterbi_layout(T, n, K, F, sms)
    _check_device_bytes(lay, T, K, F, card)
    inst, memory = lay.instance, lay.memory
    if S != 1 << (K - 1):
        raise ValueError(f"viterbi_decode: tables of {S} states for K = {K}")
    lib = _build.lib()  # raises where the kernels cannot be built
    _build.check_tensor(llr, "llr", device=dev, shape=(F, T, n))
    _build.check_tensor(tables.psym, "psym", device=dev, shape=(S, 2, n))
    bits = torch.empty((F, nbits), dtype=torch.int32, device=dev)
    dec = (torch.empty(F * T * max(1, S // 32), dtype=torch.int32, device=dev)
           if memory == "global" else None)
    metrics = (torch.empty(F * 2 * S, dtype=torch.float32, device=dev)
               if inst == "serial" and K > SMEM_MAX_K else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dp = None if dec is None else dec.data_ptr()
    with torch.cuda.device(dev):
        if inst in ("block", "cluster"):
            err = lib.viterbi_acs_launch(
                llr.data_ptr(), bits.data_ptr(), tables.psym.data_ptr(), dp,
                F, T, n, S, lay.E, lay.C, int(terminated), nbits,
                int(memory == "global"), stream)
        else:
            err = lib.viterbi_launch(
                llr.data_ptr(), bits.data_ptr(), tables.psym.data_ptr(), dp,
                None if metrics is None else metrics.data_ptr(), F, T, n, S,
                int(terminated), nbits, int(inst == "warp"),
                int(memory == "global"), stream)
    _build.check(err, "viterbi_acs_launch" if inst in ("block", "cluster")
                 else "viterbi_launch")
    counter = {"warp": "launches", "block": "block_launches",
               "cluster": "cluster_launches", "serial": "serial_launches"}
    setattr(viterbi_frames, counter[inst],
            getattr(viterbi_frames, counter[inst]) + 1)
    if memory == "global":
        viterbi_frames.global_launches += 1
    if metrics is not None:
        viterbi_frames.metric_launches += 1
    return bits


viterbi_frames.launches = 0
viterbi_frames.block_launches = 0
viterbi_frames.cluster_launches = 0
viterbi_frames.serial_launches = 0
viterbi_frames.global_launches = 0
viterbi_frames.metric_launches = 0
