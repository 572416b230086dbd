"""The bench probes on the H100 (reference: bench/exp_dma.py,
exp_dma64.py, exp_dma2.py, exp_prep.py and exp_ablate.py, the TPU
experiments that asked where the fused chain's time goes).

- ``dma``: ``window_copy`` (csrc/probes.cu), the cost of copying K3's
  input windows into shared memory, double-buffered or not, as two 64-lane
  planes or one 128-lane window, at 128-1024 lanes a row, and a direct
  read with no staging; beside a streaming ``x * c`` and ``x.clone()``.
- ``prep``: ``planes_unpack`` (csrc/probes.cu), whether a kernel can build
  the planes rows from the interleaved cf32 stream itself, and what the
  prep pass costs in front of K3.
- ``ablate``: K3 with its stages switched off at compile time
  (``chain_tile``'s variants in csrc/fm_chain.cu), each timed beside K3.
- ``ingest`` (probes/ingest.py; reference bench/bm_ingest.py): a cf32
  file through the native ring, the pinned staging and on to the card,
  in MB/s beside config #2's 800 MB/s input.

Run them on the card: ``python3 -m newsched_tpu_torch.probes``; one JSON
line a measurement. Every kernel has its plain PyTorch version beside it,
which the CPU tests and chip_smoke.py hold it against.
"""
