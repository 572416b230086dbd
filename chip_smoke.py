#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

The main paths are the three forms of the 64-channel FM channelizer
flowgraph (``newsched_tpu_torch.models.fm_channelizer``) and of the
wideband-FM receiver (``models.wbfm_receiver``), compiled by the rate
algebra and stepped by the runner, at full width. The channelizer: M=64
channels, 16 taps per arm, a 65-tap audio filter decimating by 8, batches
of 2^21 wideband samples:
  - fused (``fused=True``): source -> fused chain block (K3, K2 inside)
    -> sink, with a replayed stream or the noise source (K4);
  - staged (the default ``fused=False``): noise_source (K4) ->
    pfb_channelizer (K1) -> vector_quad_demod -> vector_fir -> sink; and a
    pfb_decimator graph (K7);
  - live (``fused=True, source="live"``): one generating source (K5).
The wideband-FM receiver (BASELINE config #1): 1 MS/s, an 81-tap channel
filter at 200 kHz decimating by 4, a 121-tap resampler decimating by 5,
75 kHz deviation, batches of 2,088,960 samples, on the fixed-point tone at
231.25 kHz:
  - staged: sig_source (K8) -> freq_xlating_fir -> quadrature_demod ->
    rational_resampler;
  - fused: sig_source (K8) -> wbfm_rcv_fused (K10), and sig_source_folded
    (K11) -> wbfm_rcv_fused(input_format="folded") (K10);
  - live: wbfm_live_source (K12), one generating source.
Config #0, the FIR chain (``models.fir_chain``): a 123,456 Hz fixed-point
tone at 1 MS/s through a 128-tap lowpass FIR, 10,000,000 samples in
batches of 2^21:
  - staged: sig_source (K8) -> fir_filter (the FP32 Toeplitz product) ->
    head;
  - live: fir_tone_source (K9), one generating source -> head.
And the fused channelizer chain's pipelined form,
``fm_chain_step_planes(pipelined=True)`` (K3p). Runs of two batches or
more take the runner's graph mode (a captured CUDA graph of a chunk of
steps, the reference's scan mode), which phase 30 holds against its loop
mode. Then the same graphs sharded, ``fg.run(mesh=make_mesh(n))`` for n = 4 and 8 logical shards on
the one card (``newsched_tpu_torch.parallel``): the live channelizer (K6),
the fused channelizer (K3 with warm > 0), and the receiver's fused (K10)
and live (K12) forms and the live FIR chain (K9), each kernel once a
batch over every shard, each graph against its unsharded graph.

Phases (each failure raises, so the script exits nonzero):
  1. device: a CUDA device is required; its name and power limit;
  2. build: nvcc builds every kernel from newsched_tpu_torch/csrc/;
  3. K4 gaussian_rows at 32768 x 128: bit-equal to its plain version,
     Irwin-Hall moments, split invariance; with and without the blocks'
     amplitude, as rows and as the cf32 stream, bit-equal to its plain
     version and to the blocks' own r * amp and torch.complex build;
  4. K2 atan2 over a (y, x) grid with the axes and signed zeros, at
     lengths 4k+1, 4k+2, 4k+3, 4k and below 4 with y and x on the 16-byte
     grid and 4 bytes off it, and at the demod's shape: <= 1e-6 from the
     plain version and from float64, (+-0, +-0) -> +0;
  5. K3 fm_chain_step_planes at n=32768 rows, two batches with carried
     state on a 64-station FM band: <= 2e-5 from the plain version, and
     bit-identical outputs for three tile sizes;
  6. the fused flowgraph over a replayed noise stream, 4 batches on the
     GPU: >= 95 dB against the float64 golden on the unambiguous samples;
  7. the fused flowgraph with its default noise source, 4 batches: the
     same gate against the golden of the regenerated stream;
  8. the launch counts of phases 6-7 show K3 and K4 ran on that path;
  9. times (CUDA events around 10 back-to-back calls, median of 30
     such reps): K3 and K4 beside their plain versions, and the fused
     flowgraph step in Msamples/s;
 10. K7 arm_fold and K1 arm_fold_dft on the FM band's commutator matrix:
     within 1e-5 of max|out| from their plain versions, bit-identical at
     their default tiles and 256; K1 (its FFT instance) bit-equal to the
     torch-float32 replay of its planes FFT on K7's output, at runs of 48
     rows, one ring and its default; K1 also at 128, 192, 256, 320, 384,
     448, 512, 960 and 1024 channels (the FFT instance, past 448 its
     run-time instance, bit-equal to the replay of K7 there too), where
     pfb_channelize launches it ("auto" up to 512 channels, by name past
     them);
     K7 within 1e-5 of its plain version and
     tile-invariant at 96 and 34 lanes, at 4, 8 and 17 taps, with v short
     of its rows and with v 4 bytes off a 16-byte boundary;
 11. the staged flowgraph with its default noise source, 4 batches:
     >= 60 dB against the golden of the regenerated stream; K1 and K4
     launched on it;
 12. a pfb_decimator graph at channel 5 equals column 5 of the
     pfb_channelizer graph within 1e-5 relative; K7 launched on it (its
     step is timed in phase 15);
 13. K5 fm_chain_gen_step, 2 carried batches, draws 3 and 2: bit-equal to
     K4 * amp -> K3 at the same tile, bit-identical at tiles 64/128/256,
     within 2e-5 of its plain version outside the golden's branch-cut
     mask;
 14. the live flowgraph, 4 batches: bit-equal to phase 7's output (the
     same stream) and >= 95 dB against its golden; K5 launched on it; a
     two-draw live flowgraph equals phase 13's first batch;
 15. times: K1, K7 and K5 beside their plain versions (and K5 beside
     K4 -> K3), the staged, live and pfb_decimator flowgraph steps in
     Msamples/s; K7 beside one library call computing its function (a
     grouped conv1d), both over 4 rotating inputs and outputs (past the
     L2) and on one input, with K7's run length and occupancy on the card;
 16. K8 nco_planes and K11 nco_folded at 2,088,960 samples: bit-equal to
     their plain versions, on a tone with a nonzero start phase and on
     phases a hair below a whole turn (quadrant 4 wraps to 0);
 17. K10 wbfm_chain_step on an FM signal, 2 carried batches: <= 2e-5 from
     its plain version, carry equal; bit-identical audio at four (tile,
     segment group) geometries and for one batch of twice the size;
 18. K12 wbfm_chain_live_step, 2 carried batches from stream start:
     bit-equal to K11 -> K10, <= 2e-5 from its plain version;
 19. the staged, fused (cf32 and folded) and live wbfm_receiver graphs, 4
     batches each: >= 60 dB against the float64 golden (the reading is
     printed); K8 launched on the staged and fused paths, K11 and K10 on
     the folded one, K10 on the fused one, K12 on the live one;
 20. times: K8, K11, K10, K12 beside their plain versions (K12 beside
     K11 -> K10), K10 and K12 over 4 rotating inputs and outputs and on
     one, K10 and K12 at each geometry, the four wbfm flowgraph steps in
     Msamples/s;
 21. K9 fir_tone_step (an overlap-save FFT convolution) at 2^21 samples,
     128 taps, D = 1 and 4, two batches from stream start and one from a
     nonzero phase, and one batch of 32700 rows, which its transforms'
     128 outputs do not divide: within 2e-5 of max|out| from its plain
     version (the direct form); bit-identical at seven block geometries
     and for four batches of 2^20 against two of 2^21;
 22. the staged and live fir_chain graphs at 10M samples in batches of
     2^21: >= 60 dB against the float64 golden each (the reading is
     printed), live against staged > 100 dB; K8 launched on the staged
     path, K9 on the live one;
 23. K3p on two carried batches of the FM band, counted: bit-equal to K3
     (audio, prev, tail), bit-identical at tiles 128 and 64 and at 1, 2
     and 4 tiles a block;
 24. times: K2 alone at the demod's shape beside its plain version and
     torch.atan2, over 4 rotating inputs and outputs and on one; K9
     beside its plain version and K11 -> conv1d(groups=128), over 4
     rotating outputs and on one, at each geometry; K3p beside K3 (alternated), at each tile and tiles a
     block; the config #0 flowgraph steps in Msamples/s;
 25. K6 fm_chain_gen_warm_step at 8192 and 4096 rows (a shard of a 4- and
     of an 8-shard batch), at stream start, at shard 3 and at group
     2^32-2, draws 3 and 2: bit-equal to K5's stream at the same rows,
     within K5_TOL of its plain version outside the golden's branch-cut
     mask; and over the 4 and 8 shards of a batch in one launch (nd = 4,
     8), bit-equal to the shards one by one and, from stream start, to
     K5 over the whole batch;
 26. the live flowgraph sharded over 4 and 8 shards, 3 batches: bit-equal
     to the unsharded live flowgraph, >= 95 dB against its golden; K6
     launched once a batch (one grid over every shard), K5 never;
 27. the fused flowgraph over the replayed stream sharded over 4 and 8
     shards, 3 batches: bit-equal to the unsharded one, >= 95 dB; K3
     launched once a batch (warm > 0, every shard in one launch); K3 over
     every shard of a batch in one launch bit-equal to its shards' calls
     one by one and within K3_TOL of its plain version with nd= off the
     branch cut; on shard 1 of each mesh, K3 with warm > 0 within K3_TOL
     of its plain version, and K3p with warm > 0 bit-equal to K3;
 28. the wbfm fused (K8 -> K10) and live (K12) graphs and the live
     fir_chain graph (K9) over 4 and 8 shards, 3 batches: bit-equal to
     their unsharded graphs, >= 60 dB each; K10, K12 and K9 launched once
     a batch; K10, K12, K9 and K9's partitioned instance over every shard
     of a batch in one launch, each bit-equal to its shards' calls one by
     one and within its tolerance of its plain version with nd=;
 29. times: K6 at 8192 and 32768 rows and over the 4 and 8 shards of a
     batch in one launch, beside K5 and its plain version;
     the sharded live and fused flowgraph steps in Msamples/s (the
     4-shard live step profiled); the graph-mode steps (two-point fit) of
     the #2 fused replay, #1 fused, #1 live and #0 live graphs unsharded
     and on 4 and 8 shards, each sharded graph in its one launch a batch
     and in the per-shard loop it ran before (probes/stages.py
     ``shard_loops``), in turns;
 30. graph mode, the runner's default on the card (a captured CUDA graph
     of runtime/runner.py's GRAPH_CHUNK steps over the stream state on
     the card): every unsharded graph (config #2 fused replay, fused
     noise, staged, live; config #1 staged, fused, folded, live; config #0
     staged, live) and the 4-shard live and fused graphs run by fg.run()
     for 2C + 1 batches (two replays and a remainder): bit-equal to
     Runner._run_loop with the same launch counts, each kernel of the path
     among them, above their gates on the batches the goldens cover;
 31. parameter changes under graph mode: a dphase change between runs of
     one runner, in sig_source and in the live receiver, keeps the captured
     chunk and equals a fresh runner's output; a center_freq change (a
     fence) captures anew and equals a fresh runner's output;
 32. K4 and K5 from the sources' counter on the card at group 2^32-2 and
     at a negative group: K4 bit-equal to its plain version in every mode
     (amplitude, cf32), K5 to K4 * amp -> K3;
 33. the probes (newsched_tpu_torch/probes): window_copy in every variant
     exactly its plain version, planes_unpack bit-equal to cplx_to_planes,
     and to its plain version (rows and next skew) at a row count off its
     rows a block, from an aligned stream and one 8 bytes off, its skew
     its own storage; K3's ablation "full" bit-equal to K3 and each variant within K3_TOL
     of max(1, max|out|) of its plain version;
 34. times: each cell's graph-mode step by the bench's two-point fit beside
     its loop-mode step and profiled device time; the graph chunk at 2, 4,
     8 and 16 steps; the bench's timer on its headline path (K1 = 10,
     K2 = 40); the probes (window copies in GB/s beside 3.35 TB/s, the
     prep pass, the ablation beside K3 and K3's time split by stage),
     counted; K3, K5, K6 and K3p beside the dense-DFT chain's times;
     planes_unpack beside torch.cat of the same skewed rows' planes,
     aligned and 8 bytes off as the kernel reads them (and of rows
     aligned to the batch); and every kernel's least time on the card for
     its work (``kernel_bounds``).

 35. K3ag, the banded audio stage (``_pick_audio_groups`` overridden to 2
     and 4): K3 (two carried batches of the FM band), K5 (from stream
     start) and K6 (8192 rows, a shard at stream start) bit-equal to ag = 1
     and within K3_TOL (K5_TOL) of their plain banded versions off the
     branch-cut mask; the fused replay, live and 4-shard live flowgraphs at
     ag = 2 bit-equal to ag = 1, K3ag's launches counted on them; each
     kernel's time at ag = 1, 2 and 4;
 36. tags: the fused flowgraph over a replayed cf32 batch with
     vector_source(tags=...), 3 batches through a captured chunk: tag
     offsets the input offsets / (M * decim) exactly, payloads intact, the
     audio bit-equal to the untagged graph's; with tag_capacity_limit=1 and
     two tags in one batch, one drop counted;
 37. checkpoints: the live channelizer (K5) and the live receiver (K12),
     2N batches straight through against N, a checkpoint and N resumed:
     bit-equal;
 38. unbounded runs under fg.start()/stop(): the live channelizer into a
     null_sink and into a vector_sink(capacity=12288) through replays of
     the captured chunk (K5 once a batch, batches a multiple of
     GRAPH_CHUNK), the ring the last items of a bounded run of the same
     length; a center_freq change (a fence) from this thread during an
     unbounded config #1 fused run lands at a chunk boundary, the output
     before it a run at the old value, after it a run at the new one;
 39. times: the unbounded live run's rate beside phase 34's graph-mode
     step; the throttle's pacing error at 10 Msamples/s;
 40. K9's partitioned instance (past the FFT's 513 taps) at 514, 1024 and
     6001 taps, D = 1 and 4: within K9_TOL of its plain version,
     bit-identical at tile 256 and across a batch split on a multiple of
     its L = 512 outputs, counted on partitioned_launches; a tap count
     past its stated limit raises naming the limit; the live fir_chain at
     1024 taps, two batches in graph mode, >= 60 dB against its float64
     golden, the partitioned instance launched on it;
 41. K3, K5 and K6 at M = 128, 256, 320, 384, 448, 512 and 1024 (16384 rows
     a batch): K3 within K3_TOL of its plain version on an M-station FM
     band, tile-invariant; K5 bit-equal to K4 * amp -> K3 and within
     K5_TOL of its plain version off the branch cut; K6 bit-equal to K5's
     stream at shard 3 and over 4 shards in one launch, and within K5_TOL
     of its plain version; at every other M = 64 P, P = 3 .. 15 (192,
     576 .. 960; 4096 rows a batch) K3 within K3_TOL of its plain version
     and tile-invariant, K5 bit-equal to K4 * amp -> K3 and K6 over 4
     shards to K5;
 42. the fused (replayed FM band) and live fm_channelizer flowgraphs at M =
     128, 256, 320, 384, 448, 512 and 1024, two batches in graph mode: >= 95 dB against the float64
     golden off its branch-cut mask, and the live graph on 4 shards (K6
     once a batch, bit-equal); at M = 128 also at half the batch
     (bit-equal) and the staged graph (>= 60 dB, K1 launched); launches
     counted;
 43. times at M = 128, 320, 384, 448, 512 and 1024: K3, K5 and K6 (at M =
     128 on a
     shard's 4096 rows, past it over the 4 shards of a batch in one
     launch) beside their plain versions and bounds, and K1 at M = 128;
     K9's partitioned instance at 1024 and 6001 taps beside its plain
     version;
 44. config #3's two overlap-save engines (ops/fir.py "fft": "xla", cuFFT,
     and "mxu", the Bailey products) at 1024 taps over three uneven
     batches around 2^21, and on one segment (16384 samples at fft_size
     16384): >= 85 dB each against float64; the engine "auto" picks; each
     engine's time over 4 rotating inputs and on one beside the bound of
     its bytes; the cuFFT engine at fft_size 4096 to 32768;
 45. config #3's flowgraph (noise_source (K4) -> fft_filter -> head) in
     graph mode: bit-equal to the loop, K4 launched, >= 85 dB against the
     float64 golden of the regenerated stream; its two-point step, loop
     step and profile; tags through fft_filter at decim 2, offsets exact;
 46. ShardedFirFilter on 4 logical shards at 1024 taps, decim 2, two
     batches with tags: >= 120 dB against the unsharded filter, tag offsets
     exact;
 47. config #1 staged, fused, folded and live with deemph_tau=75e-6 in
     graph mode: >= 60 dB against the float64 golden de-emphasised; the
     de-emphasis (iir_filter at 104448 samples) timed beside K10, and the
     fused step with and without it;
 48. AGC, an order-4 Butterworth iir_filter, the fft block and math and
     streamops blocks on the card against their CPU runs; the AGC's and
     the rotator's state constructors on the card by default;
 49. the channelizer past 256 channels on its main path: the staged
     fm_channelizer in graph mode at M = 320, 512 and 1024
     (pfb_channelize's "auto" takes K1, counted; K7 never), >= 60 dB each,
     and each step's time; pfb_channelize by method="fused" and "auto" at
     M = 512, 960 and 1024, K1 launched once each, within FOLD_TOL of K7
     and the combine; K1's time at M = 320 .. 1024 beside its plain
     version, its bound and (M = 320) the dense instance's time there
     before; K1 at every M = 512 .. 1024 (P = 8 .. 16) bit-equal to the
     FFT replay of K7's output and within FOLD_TOL of its plain version,
     and at M = 512, 576, 704, 896 and 1024 timed beside K7 + cuFFT's
     combine, the other route "auto" could take;
 50. S1 costas_loop (orders 2, 4, 8) and S2 clock_recovery_mm (sps 4) at
     32768 samples on 1 and 64 streams against their plain versions (run
     on the CPU): within 1e-4 of max|y|, the state within the same, S1's
     decisions identical; two batches bit-equal to one; their times beside
     the bytes bound and the serial floor of their critical path;
 51. S3 viterbi_decode at 1024 frames of 512 bits, K = 7 and 3 (its warp
     instance) and 11 (its block instance), hard and soft, each launch
     counted on its instance: bit-equal to its plain version; no errors on
     the noiseless code and with four separated coded bits flipped a
     frame; its time at 1024 frames and at one beside the block-a-frame
     design's and its bound; then its routes past those frames and codes,
     each a FEC link (cc_encoder -> BPSK + AWGN -> cc_decoder) of two
     batches in graph mode and direct calls, bit-equal to the plain
     version, each launch counted on its instance and route: 16384-bit
     frames at K = 7 (the warp instance, decisions in device memory), a
     rate-1/5 code at K = 7 (the block instance), a K = 12 code (the
     block instance, two states a thread) and a K = 16 code (the block
     instance, its metrics in device memory, error-free at 7 dB), and
     frames of the rate-1/5 and K = 12 codes past shared memory (device
     memory); each route's time beside its plain version and bound;
 52. S1 and S2 at the QPSK link's shapes against their plain versions and
     timed (the kernels line's); the QPSK link (``models.qpsk_tx`` on the
     card, a channel of 0.3 rad, 0.5 sample and 20 dB, ``qpsk_receiver``)
     over 8 batches of 2^20 samples in graph mode: the sent symbols from
     symbol 2000 at the link's lag in every batch, but at the 36 symbols
     where the reference's receiver errs on the same stream, and there the
     same errors; S1 and S2 launched;
     graph mode bit-equal to the loop at batches of 2^18, which equal
     batches of 2^20; the step's two-point time, loop time and profile;
 53. the FEC link (cc_encoder, BPSK + AWGN, cc_decoder: S3) over 8
     batches of 1024 frames in graph mode: bit-equal to S3's plain version
     on the same LLRs, error-free at 7 dB, at the reference's sigma 0.65 a
     BER under a fifth of the raw; S3 (its warp instance) launched; the
     step's two-point time beside the block-a-frame design's.
 54. the host boundary (newsched_tpu_torch/io, blocks/fileio.py,
     blocks/network.py, the runner's staging): the ingest probe
     (probes/ingest.py) over a 256 MB file of seeded cf32 in batches of
     2^21, page cache warm: the native ring alone, with the runner's pinned
     staging, and on to the card with a checksum there (the host's), each
     in MB/s beside the 800 MB/s target; the ring carried every byte;
 55. config #2 at full width, fused (cplx_to_planes -> K3) and staged
     (pfb_channelizer on K1 -> demod -> vector_fir), over the file's 16
     batches: fed from the file through file_source(use_native=True) in
     the runner's loop (never captured), counted, its ring carrying the
     whole file, and fed from memory in graph mode;
 56. file_sink's bytes equal to the memory-fed graph's output bit for bit,
     the first 2 batches above the golden's gates (95 dB fused, 60 staged);
 57. a TCP loopback: a thread serves 4 batches of the file into tcp_source
     (the ring's fd pump) -> fused config #2 -> tcp_sink (the ring's drain)
     -> a reading thread, bit-equal to the memory-fed graph, K3 counted;
 58. times: the file-fed fused and staged graphs in loop mode, ms a batch
     and Msamples/s (the median of 3 runs over the file) and the card's
     busy share in a traced run, beside the same graphs fed from memory in
     graph mode and phase 34's cells;
 59. partitions (runtime/distributed.py, io/zmtp.py): config #2 fused noise
     (K4 -> K3) at full width split by partition_flowgraph into "dsp" and
     "tail", run by Runtime.run() on two threads, about 1 MB of audio a
     batch through the port's ZMTP over TCP loopback, counted, 16 batches
     bit-equal to the unpartitioned graph; its ms a batch and busy share
     beside the same graph unpartitioned in the runner's loop on the same
     host clock (a file_sink to os.devnull keeps it out of graph mode), its
     graph-mode device step and the transport alone;
 60. config #1 fused (K8 -> K10) at full width in a child process
     (``chip_smoke.py --radio``, the kernels loaded from the parent's
     build), tuned to 200 kHz under a keyed ControlServer (runtime/
     control.py); this process pulls its audio over TCP, and once it holds
     the first batch retunes it to 290 kHz; an unkeyed client and a frame
     that would open a file when unpickled refused, a replayed keyed frame
     refused; one switched batch, every batch before it bit-equal to a
     local run at 200 kHz, every one after it to one at 290 kHz; the edge
     holds 2 batches at each end, so the child cannot run far ahead;
 61. the port's examples (newsched_tpu_torch/examples/) on the card, each
     its main("cuda"), but yaml_block (PyYAML, which this machine lacks);
 62. the chains with the model's own 193-tap audio FIR, longer than their
     128-row tile: K3 against its plain version and across tiles, K5
     against K4 -> K3, K6 against K5, at M = 64, 128 and 512; the live
     and the fused noise model with their default FIR bit-equal.

``python3 chip_smoke.py --phases 59-62`` builds the kernels and runs
phases 59-62 alone, checked as in the whole run, and prints their
numbers as one JSON line, with no result line.

Kernel times are device times: 10 calls captured in a CUDA graph and the
graph replayed under CUDA events (median of 30), so the host's launch
time is left out (``graph_ms``); K7, its conv1d, K2, torch.atan2 and the
probes' copies take the next of 4 inputs each call and keep their
outputs (the probes' ``rotating``), so their bytes come from device
memory, not the L2; plain versions and flowgraph steps are timed as a
caller runs them, host included (``median_ms``). Each timed
unsharded flowgraph step, and one sharded one, is also traced for 20 steps
with torch.profiler and its device time printed kernel by kernel.

The bench probes (window copies, the planes unpack, K3's ablation) run
last, through ``newsched_tpu_torch.probes.run``, the probes' entry point.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

M, L, DECIM, A = 64, 16, 8, 65
DEMOD_GAIN = 0.5
BATCH = 1 << 21            # wideband samples per batch
ROWS = BATCH // M          # planes rows per batch (32768)
N_AUD = ROWS // DECIM      # audio rows per batch (4096)
SNR_GATE_DB = 95.0         # fused and live chains (the reference's gate)
STAGED_GATE_DB = 60.0      # the staged graph (the reference's gate for it)
K3_TOL = 2e-5              # fused kernel vs its plain version, FP32 both
K5_TOL = 2e-5              # generating kernel vs its plain version
K2_TOL = 1e-6              # atan2 vs plain and vs float64
FOLD_TOL = 1e-5            # K1/K7 vs plain, relative to max|out|
DEC_TOL = 1e-5             # pfb_decimator vs the channelizer's column
DEC_CHANNEL = 5
REPS = 30
PLAIN_REPS = 10            # the slow plain versions of K1, K7, K5
WIDE_PLAIN_REPS = 3        # theirs past 256 channels (phase 43), 10-84 ms a call
_GOLDEN: dict = {}         # float64 goldens by stream, computed once
LOOP: dict = {}            # cell -> (loop-mode step ms, profiled device ms)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(ptxas_line: str) -> str:
    """The kernel's name in ptxas' 'Compiling entry function' line: the
    length-prefixed part of the mangled name that ends in _kernel, with its
    integer template arguments (an instance's width, taps, states)."""
    for m in re.finditer(r"(?=(\d+))", ptxas_line):  # every digit suffix
        n = m.group(1)
        end = m.start() + len(n) + int(n)
        name = ptxas_line[m.start() + len(n):end]
        if name.endswith("_kernel") and name.isidentifier():
            args = re.match(r"I((?:Li\d+E)+)E", ptxas_line[end:])
            if args:
                name += "<" + ",".join(re.findall(r"Li(\d+)E", args[1])) + ">"
            return name
    return "?"


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int = REPS, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``inner`` back-to-back
    calls, divided by ``inner``; the median over ``reps`` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return float(np.median(times))


def design():
    from newsched_tpu_torch.ops import firdes

    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.4 / DECIM, 0.1 / DECIM, ntaps=A)
    return taps, audio_taps


def fm_band(n_samples: int, device, m: int = M) -> np.ndarray:
    """An m-station FM band (64 by default): one carrier at each channel
    centre k/m, each frequency-modulated by its own tone so that the
    demodulated angle per channel sample stays within +-0.4 rad, far from
    the +-pi branch cut (a kernel-vs-plain comparison of noise would flip
    there on a 1-ulp difference)."""
    import torch

    n = torch.arange(n_samples, dtype=torch.float64, device=device)
    x = torch.zeros(n_samples, dtype=torch.complex128, device=device)
    for k in range(m):
        fm = (k + 1) * 1e-6                       # message tone, cycles/sample
        beta = 0.4 / (2 * np.pi * m * fm)         # peak step 0.4 rad/channel sample
        phase = 2 * np.pi * k * n / m + beta * torch.sin(2 * np.pi * fm * n + k)
        x += torch.polar(torch.ones_like(phase), phase)
    return (x / 8).to(torch.complex64).cpu().numpy()


def phase_k4(torch, noise):
    dev = "cuda"
    rows = noise.gaussian_rows(0, n_rows=ROWS, width=2 * M, seed=5, device=dev)
    plain = noise.gaussian_rows_plain(0, n_rows=ROWS, width=2 * M, seed=5,
                                      device=dev)
    err = float((rows - plain).abs().max())
    require(torch.equal(rows, plain), f"K4: kernel != plain version ({err})")
    r = rows.double().cpu().numpy()
    n = r.size
    mean, std, mx = abs(r.mean()), r.std(), np.abs(r).max()
    kurt = float(np.mean(r**4) / np.mean(r**2) ** 2 - 3.0)
    log(f"K4 moments: |mean| {mean:.3e} (< {5/np.sqrt(n):.3e}), std {std:.6f}, "
        f"max|x| {mx:.4f}, excess kurtosis {kurt:.4f}")
    require(mean < 5 / np.sqrt(n) and abs(std - 1) < 0.01 and mx <= 4.25
            and abs(kurt + 0.2) < 0.05, "K4: moments out of bounds")
    half = ROWS // 2
    parts = torch.cat([
        noise.gaussian_rows(0, n_rows=half, width=2 * M, seed=5, device=dev),
        noise.gaussian_rows(half // noise.GROUP_ROWS, n_rows=half, width=2 * M,
                            seed=5, device=dev)])
    require(torch.equal(parts, rows), "K4: two half batches != one batch")
    k4_modes(torch, noise, noise.group_tensor(0, dev), False)
    amp = torch.tensor(-0.3, dtype=torch.float32, device=dev)
    cf = noise.gaussian_rows(0, n_rows=ROWS, width=2 * M, seed=5, device=dev,
                             amp=amp, layout="cf32")
    require(torch.equal(cf, torch.complex(rows[:, :M].reshape(-1) * amp,
                                          rows[:, M:].reshape(-1) * amp)),
            "K4 cf32: not the noise source's torch.complex build")
    log(f"K4: bit-equal to plain (max abs err {err}); split-invariant; with "
        f"and without an amplitude, as rows and as the cf32 stream, bit-equal "
        f"to plain and to the blocks' own r * amp and torch.complex build")
    return err


def k4_modes(torch, noise, g, mask: bool) -> None:
    """K4 at base group ``g`` (a tensor on the card), with and without an
    amplitude (a negative one: zeros of mask_pre come out -0), as rows and
    as the cf32 stream: bit-equal to its plain version."""
    amp = torch.tensor(-0.3, dtype=torch.float32, device="cuda")
    for layout in noise.LAYOUTS:
        for a in (None, amp):
            kw = dict(n_rows=ROWS, width=2 * M, seed=5, device="cuda",
                      mask_pre=mask, amp=a, layout=layout)
            got = noise.gaussian_rows(g, **kw)
            ref = noise.gaussian_rows_plain(int(g), **kw)
            require(got.dtype == ref.dtype and torch.equal(got, ref),
                    f"K4 at group {int(g)}, mask_pre {mask}, layout {layout}, "
                    f"amp {a is not None}: differs from its plain version")


def k2_check(mathfns, yt, xt, what: str):
    """K2 on (yt, xt) against its plain version and float64: within K2_TOL
    of both, (+-0, +-0) -> +0. Returns the error against the plain and
    K2's output (numpy)."""
    got = mathfns.atan2(yt, xt)
    plain = mathfns.atan2_plain(yt, xt)
    g = got.cpu().numpy()
    y, x = yt.cpu().numpy(), xt.cpu().numpy()
    err_plain = float(np.abs(g - plain.cpu().numpy()).max(initial=0.0))
    # angles compared modulo 2 pi: on the negative real axis a signed zero
    # y puts IEEE atan2 at -pi where the polynomial (like the reference's)
    # gives +pi
    ref = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    zeros = (x == 0) & (y == 0)
    ref[zeros] = 0.0
    err_f64 = float(np.abs(np.angle(np.exp(1j * (g - ref)))).max(initial=0.0))
    require(err_plain <= K2_TOL and err_f64 <= K2_TOL,
            f"K2 {what}: error above {K2_TOL} ({err_plain:.3e} vs plain, "
            f"{err_f64:.3e} vs float64)")
    require(np.all(g[zeros] == 0) and not np.any(np.signbit(g[zeros])),
            f"K2 {what}: (+-0, +-0) is not +0")
    return err_plain, g


def phase_k2(torch, mathfns):
    vals = np.array([-3.0, -1.0, -1e-3, -1e-30, -0.0, 0.0, 1e-30, 1e-3, 1.0,
                     3.0], np.float32)
    rng = np.random.default_rng(2)
    y = np.concatenate([np.repeat(vals, len(vals)),
                        rng.standard_normal(1 << 20).astype(np.float32)])
    x = np.concatenate([np.tile(vals, len(vals)),
                        rng.standard_normal(1 << 20).astype(np.float32)])
    yt, xt = torch.from_numpy(y).cuda(), torch.from_numpy(x).cuda()
    err_plain, g = k2_check(mathfns, yt, xt, "grid")
    log(f"K2 atan2: max err vs plain {err_plain:.3e}; (+-0, +-0) -> "
        f"{np.unique(g[(x == 0) & (y == 0)])}")
    # the launch's edges: lengths off its 4-element words (the tail), y
    # and x one float past the 16-byte grid (one element a thread), and
    # lengths below 4; signed-zero pairs every 7th element and first
    ye = rng.standard_normal(8192).astype(np.float32)
    xe = rng.standard_normal(8192).astype(np.float32)
    sz = np.array([[-0.0, -0.0], [0.0, -0.0], [-0.0, 0.0], [0.0, 0.0]],
                  np.float32)
    ye[::7], xe[::7] = np.resize(sz[:, 0], ye[::7].size), \
        np.resize(sz[:, 1], xe[::7].size)
    ye, xe = (torch.from_numpy(np.concatenate([sz[:, i], v])).cuda()
              for i, v in ((0, ye), (1, xe)))
    cases = 0
    for n in (4 * 1024 + 1, 4 * 1024 + 2, 4 * 1024 + 3, 3, 2, 1, 4 * 2047):
        for off in (0, 1):
            yv, xv = ye[off:off + n], xe[off:off + n]
            require(yv.data_ptr() % 16 == 4 * off and xv.data_ptr() % 16
                    == 4 * off, "K2: the inputs' offset is not the one meant")
            err_plain = max(err_plain, k2_check(
                mathfns, yv, xv, f"length {n}, offset {4 * off} B")[0])
            cases += 1
    log(f"K2 at {cases} lengths and offsets (4k+1, 4k+2, 4k+3, 3, 2, 1, 4k; "
        f"on the 16-byte grid and 4 bytes off): within {K2_TOL} of plain "
        f"and float64, (+-0, +-0) -> +0")
    # at the demod's shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    d = torch.randn(2, ROWS, M, device="cuda", generator=gen)
    err = float((mathfns.atan2(d[0], d[1])
                 - mathfns.atan2_plain(d[0], d[1])).abs().max())
    log(f"K2 at ({ROWS}, {M}): max err vs plain {err:.3e}")
    require(err <= K2_TOL, "K2: error above 1e-6 at the demod's shape")


def chain_consts():
    """The fused block's chain constants (fold taps, DFT matrix, audio
    taps) on the GPU."""
    from newsched_tpu_torch.blocks import vector_dsp

    taps, audio_taps = design()
    return vector_dsp.fm_channelizer_fused_planes(
        M, taps, audio_taps, audio_decim=DECIM).consts("cuda")


def k3_batches(torch, fm_chain, consts, rows, step, **kw):
    """Two carried batches of ROWS planes rows through ``step`` (K3, its
    plain version, or K3p): [aud, prev, tail] per batch."""
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    halo, prev, tail = torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z), \
        torch.zeros(A - 1, 2 * M, **z)
    outs = []
    for b in range(2):
        vb = rows[b * ROWS:(b + 1) * ROWS]
        aud, prev, tail = step(vb, halo, prev, tail, consts, DECIM, DEMOD_GAIN,
                               **kw)
        outs += [aud, prev, tail]
        halo = vb[-H8:].contiguous()
    return outs


def band_rows(torch):
    """Two batches of the FM band as planes rows on the GPU."""
    from newsched_tpu_torch.testing import planes_rows

    return torch.from_numpy(planes_rows(fm_band(2 * BATCH, "cuda"), M)).cuda()


def phase_k3(torch, fm_chain):
    consts = chain_consts()
    rows = band_rows(torch)
    got = k3_batches(torch, fm_chain, consts, rows, fm_chain.fm_chain_step_planes)
    ref = k3_batches(torch, fm_chain, consts, rows,
                     fm_chain.fm_chain_step_planes_plain)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    log(f"K3 fm_chain_step_planes: 2 batches x {ROWS} rows, max abs err vs "
        f"plain (audio, prev, tail) {err:.3e} (tol {K3_TOL})")
    require(err <= K3_TOL, "K3: kernel disagrees with its plain version")
    for tile in (256, 64):
        other = k3_batches(torch, fm_chain, consts, rows,
                           fm_chain.fm_chain_step_planes, tile=tile)
        require(all(torch.equal(a, b) for a, b in zip(got, other)),
                f"K3: tile {tile} output differs from tile 128")
    log("K3: tiles 128, 256, 64 give bit-identical audio, prev and tail")
    return err


def flowgraph(source, n_batches: int, sink="vector", fused=True, **kw):
    from newsched_tpu_torch import models

    taps, audio_taps = design()
    return models.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=DECIM, fused=fused,
        source=source, batch_size=BATCH, sink=sink,
        n_samples=None if n_batches is None else n_batches * N_AUD,
        deviation_frac=1.0 / (2 * np.pi * DEMOD_GAIN), audio_taps=audio_taps,
        **kw)


def golden(rows: np.ndarray, key: str):
    """The float64 golden of planes rows and its branch-cut mask, computed
    once per stream ``key``."""
    from newsched_tpu_torch.testing import rows_reference

    if key not in _GOLDEN:
        taps, audio_taps = design()
        _GOLDEN[key] = rows_reference(rows, taps, audio_taps, nchans=M,
                                      audio_decim=DECIM, demod_gain=DEMOD_GAIN,
                                      return_risk=True)
    return _GOLDEN[key]


def gate(rows: np.ndarray, got: np.ndarray, what: str, key: str,
         gate_db: float = SNR_GATE_DB, n_batches: int | None = None) -> float:
    """SNR of ``got`` against the golden of stream ``key`` (its first
    ``n_batches`` batches where given) on the samples off the branch cut."""
    from newsched_tpu_torch.testing import snr_db

    ref, bad = golden(rows, key)
    if n_batches is not None:
        ref, bad = ref[:n_batches * N_AUD], bad[:n_batches * N_AUD]
    require(got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}")
    require(bool(np.isfinite(got).all()), f"{what}: non-finite audio")
    snr = snr_db(ref[~bad], got[~bad])
    log(f"{what}: {got.shape[0]} audio rows x {M} channels, SNR vs float64 "
        f"golden {snr:.2f} dB on {int((~bad).sum())} samples "
        f"({int(bad.sum())} masked at the branch cut; gate {gate_db} dB)")
    require(snr >= gate_db, f"{what}: SNR {snr:.2f} dB < {gate_db}")
    return snr


def phase_replay(rows):
    from newsched_tpu_torch.blocks import general

    fg, blks = flowgraph(general.vector_source(rows, repeat=True), 4)
    fg.run(device="cuda")
    got = blks["sink"].data()
    gate(np.concatenate([rows] * 4), got, "replay flowgraph", "replay")
    return got


def noise_rows(torch, noise, n_batches: int, draws: int = 3) -> np.ndarray:
    """The default noise stream (seed 0) x 0.5 as planes rows, regenerated
    by the plain generator on the GPU."""
    amp = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    return (noise.gaussian_rows_plain(0, n_rows=n_batches * ROWS,
                                      width=2 * M, seed=0, device="cuda",
                                      draws=draws) * amp).cpu().numpy()


def phase_noise(torch, noise) -> np.ndarray:
    fg, blks = flowgraph(None, 4)
    fg.run(device="cuda")
    got = blks["sink"].data()
    gate(noise_rows(torch, noise, 4), got, "noise-source flowgraph", "noise")
    return got


def fg_step_rate(torch, fg, label: str, card: str, n_in: int,
                 mesh=None, profile: bool = True) -> float:
    """Device time of one compiled flowgraph step, streaming batch after
    batch (median over REPS runs of 10 steps), as Msamples/s of its
    ``n_in`` input samples; then, with ``profile``, a profile of the
    step."""
    from newsched_tpu_torch.runtime.runner import Runner

    fg.validate()
    runner = Runner(fg, batch_size=fg.batch_size, device="cuda", mesh=mesh)
    params = runner.init_params()
    box = {"s": runner.init_states()}

    def one():
        box["s"], _ = runner.cfg.step(box["s"], params)

    ms = median_ms(one)
    log(f"flowgraph step ({label}): {ms:.4f} ms per batch of {n_in} samples"
        f" = {n_in / ms / 1e3:.1f} Msamples/s [{card}]")
    LOOP[label] = (ms, profile_steps(torch, one, label) if profile else None)
    return ms


def step_rate(torch, source, label: str, card: str, mesh=None,
              profile: bool = True, **kw) -> float:
    fg, _ = flowgraph(source, None, sink="null", **kw)
    return fg_step_rate(torch, fg, label, card, BATCH, mesh, profile)


def profile_steps(torch, step, label: str, n: int = 20) -> float:
    """Device time per step, kernel by kernel, over n traced steps; returns
    the total in ms. The trace sometimes loses a window's device events
    (a kernel counted 0.6 times a step): then it traces again, up to
    three times, and keeps the last."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        rows = sorted(((e.device_time_total / n / 1e3, e.count / n, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.device_time_total > 0), reverse=True)
        if all(float(c).is_integer() for _, c, _ in rows):
            break
    total = sum(r[0] for r in rows)
    log(f"profile ({label}): device kernels {total:.4f} ms per step")
    for ms, count, key in rows:
        log(f"  {ms:.4f} ms x{count:g} {key[:100]}")
    return total


def fold_consts(torch, channelizer):
    """K7/K1 constants of the flagship channelizer on the GPU: fold taps
    (L, 2M), the interleaved DFT matrix (2M, 2M; the plain version's) and
    K1's FFT table (4, M)."""
    from newsched_tpu_torch.ops import pfb

    taps, _ = design()
    consts = pfb.pfb_consts(pfb.pfb_arm_taps(taps, M), "cuda")
    return consts.c2, consts.w2, consts.fft


def commutator(torch, channelizer, x: np.ndarray):
    """The interleaved commutator matrix of a stream's first batch, as the
    staged channelizer builds it: (ROWS + L - 1, 2M) f32 on the GPU."""
    xfull = np.concatenate([np.zeros(M * L - 1, np.complex64), x])
    V = torch.from_numpy(xfull[:(ROWS + L - 1) * M].reshape(-1, M)).cuda()
    return channelizer.complex_to_interleaved(V)


def phase_k1_k7(torch, channelizer) -> dict:
    c2, w2, fft = fold_consts(torch, channelizer)
    v = commutator(torch, channelizer, fm_band(BATCH, "cuda"))
    errs = {}
    for name, args, kw in (("arm_fold", (c2,), {}),
                           ("arm_fold_dft", (c2, w2), {"fft": fft})):
        kernel = getattr(channelizer, name)
        plain = getattr(channelizer, name + "_plain")
        got, ref = kernel(v, *args, ROWS, **kw), plain(v, *args, ROWS)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"{name}: {ROWS} x {2 * M} rows, max abs err vs plain {err:.3e} "
            f"= {err / scale:.3e} of max|out| {scale:.3f} (tol {FOLD_TOL})")
        require(err <= FOLD_TOL * scale, f"{name}: kernel disagrees with plain")
        require(torch.equal(got, kernel(v, *args, ROWS, tile=256, **kw)),
                f"{name}: tile 256 output differs from the default tile")
        errs[name] = err
    log("K7, K1: the default tile and tile 256 give bit-identical outputs")
    k1_is_fft_of_k7(torch, channelizer, v, c2, w2, fft)
    errs["arm_fold"] = max(errs["arm_fold"], k7_shapes(torch, channelizer))
    k1_m = sorted(set(WIDE_M + K1_WIDE_M) | {m for m in INSTANCE_M if m <= 448})
    for m in k1_m:
        errs[f"K1 M={m}"] = k1_wide(torch, channelizer, m)
    errs["arm_fold_dft"] = max(errs["arm_fold_dft"], *(
        errs[f"K1 M={m}"] for m in k1_m if m <= 448))
    return errs


def fold_taps(torch, m: int, taps: int):
    """The interleaved (taps, 2m) fold taps of an m-channel channelizer."""
    from newsched_tpu_torch.ops import firdes, pfb

    arm = pfb.pfb_arm_taps(firdes.prototype_channelizer_taps(m, taps), m)
    return pfb.pfb_consts(arm, "cuda").c2


def k1_is_fft_of_k7(torch, channelizer, v, c2, w2, fft) -> None:
    """K1 bit-equal to the torch-float32 replay of its FFT
    (``channelizer.fft_interleaved``) on K7's output, on the card, at the
    flagship's 128 lanes: K1's fold is K7's fmaf chain and its transform
    the replay's operations, each rounded on its own. Also at run lengths
    of 48 rows and one ring."""
    got = channelizer.arm_fold_dft(v, c2, w2, ROWS, fft=fft)
    rep = channelizer.fft_interleaved(channelizer.arm_fold(v, c2, ROWS), fft)
    require(torch.equal(got, rep),
            "K1 differs from the FFT replay of K7's fold")
    for run in (48, 1):
        require(torch.equal(got, channelizer.arm_fold_dft(
            v, c2, w2, ROWS, tile=run, fft=fft)),
                f"K1 at runs of {run} rows differs from the default runs")
    log("K1: bit-equal to the torch-float32 FFT replay of K7's output; runs "
        "of 48 rows, one ring and the default give the same bits")


# K7 beyond the flagship: (channels m, taps, rows short of n_out + taps - 1,
# floats v starts past a 16-byte boundary)
K7_CASES = ((48, L, 5, 0), (17, L, 0, 0), (M, 17, 0, 0), (M, 4, 3, 0),
            (M, 8, 0, 0), (M, L, 0, 1))


def k7_shapes(torch, channelizer, n_out: int = 4096) -> float:
    """K7 within FOLD_TOL of its plain version, and the same bits at tiles
    7 and 256 as at its default, at 96 and 34 lanes (float4 and float2
    lanes of the generic width), at 17 taps (the generic tap count) and 4
    and 8, with v short of its rows (they read as 0), and with v 4 bytes
    off a 16-byte boundary (one float a lane)."""
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(7)
    for m, taps, short, off in K7_CASES:
        W, rows = 2 * m, n_out + taps - 1 - short
        buf = torch.randn(rows * W + off, device="cuda", generator=g)
        v = buf[off:].view(rows, W)
        cc = fold_taps(torch, m, taps)
        got = channelizer.arm_fold(v, cc, n_out)
        ref = channelizer.arm_fold_plain(v, cc, n_out)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        what = (f"K7 at {W} lanes, {taps} taps, v {short} rows short, "
                f"offset {4 * off} B")
        log(f"{what}: max abs err vs plain {err:.3e} = {err / scale:.3e} of "
            f"max|out| (tol {FOLD_TOL})")
        require(err <= FOLD_TOL * scale, f"{what}: disagrees with plain")
        for tile in (7, 256):
            require(torch.equal(got, channelizer.arm_fold(v, cc, n_out,
                                                          tile=tile)),
                    f"{what}: tile {tile} differs from the default tile")
        worst = max(worst, err)
    return worst


def k1_wide(torch, channelizer, m: int, n_out: int = 4096) -> float:
    """K1 at m channels (2m lanes, m in planes_fft.CHANNELS): pfb_channelize
    launches it ("auto" where it takes K1, else by name), bit-equal to the
    FFT replay of K7's output; it agrees with its plain version, and runs
    of 48 rows give the default's bits."""
    from newsched_tpu_torch.ops import firdes, pfb

    arm = pfb.pfb_arm_taps(firdes.prototype_channelizer_taps(m, L), m)
    consts = pfb.pfb_consts(arm, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(n_out * m, dtype=torch.complex64, device="cuda", generator=gen)
    fn = channelizer.arm_fold_dft
    before, k7 = fn.launches, channelizer.arm_fold.launches
    method = "auto" if pfb.auto_method(m) == "fused" else "fused"
    pfb.pfb_channelize(arm, pfb.pfb_init_state(m * L, "cuda"), x,
                       method=method, consts=consts)
    require(fn.launches == before + 1 and channelizer.arm_fold.launches == k7,
            f"pfb_channelize {method} at M={m} did not launch K1 alone")
    xfull = torch.cat([torch.zeros(m * L - 1, dtype=x.dtype, device="cuda"), x])
    v = channelizer.complex_to_interleaved(
        xfull[:(n_out + L - 1) * m].reshape(-1, m))
    got = fn(v, consts.c2, consts.w2, n_out, fft=consts.fft)
    ref = channelizer.arm_fold_dft_plain(v, consts.c2, consts.w2, n_out)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"arm_fold_dft at M={m} ({'run-time P' if m > 448 else 'FFT'} "
        f"instance): {n_out} x {2 * m} rows, max abs err vs plain {err:.3e} "
        f"= {err / scale:.3e} of max|out| (tol {FOLD_TOL}); launched by "
        f"pfb_channelize {method}")
    require(err <= FOLD_TOL * scale, f"K1 at M={m} disagrees with plain")
    rep = channelizer.fft_interleaved(
        channelizer.arm_fold(v, consts.c2, n_out), consts.fft)
    require(torch.equal(got, rep), f"K1 at M={m} differs from the FFT "
            f"replay of K7's output")
    require(torch.equal(got, fn(v, consts.c2, consts.w2, n_out, tile=48,
                                fft=consts.fft)),
            f"K1 at M={m}: tile 48 differs from the default tile")
    return err


def phase_staged(torch, noise, channelizer) -> dict:
    fg, blks = flowgraph(None, 4, fused=False)
    channelizer.arm_fold_dft.launches = 0
    noise.gaussian_rows.launches = 0
    fg.run(device="cuda")
    launches = {"arm_fold_dft": channelizer.arm_fold_dft.launches,
                "gaussian_rows": noise.gaussian_rows.launches}
    log(f"launches on the staged path: {launches}")
    require(all(n > 0 for n in launches.values()),
            "a kernel of the staged path was never launched")
    from newsched_tpu_torch.testing import planes_rows

    r = noise.gaussian_rows_plain(0, n_rows=4 * ROWS, width=128, seed=0,
                                  device="cuda")
    x = (torch.complex(r[:, :64].reshape(-1), r[:, 64:].reshape(-1))
         * 0.5).cpu().numpy()
    gate(planes_rows(x, M), blks["sink"].data(), "staged flowgraph", "staged",
         STAGED_GATE_DB)
    return launches


def phase_decimator(torch, channelizer) -> int:
    from newsched_tpu_torch import Flowgraph
    from newsched_tpu_torch.blocks import filter as filt, general

    taps, _ = design()
    x = fm_band(2 * BATCH, "cuda")
    out = {}
    for name, blk, vlen in (
            ("channelizer", filt.pfb_channelizer(M, taps=taps), (M,)),
            ("decimator", filt.pfb_decimator(M, DEC_CHANNEL, taps=taps), ())):
        fg = Flowgraph(batch_size=BATCH)
        snk = general.vector_sink(dtype="cf32", vlen=vlen)
        fg.connect(general.vector_source(x), 0, blk, 0)
        fg.connect(blk, 0, snk, 0)
        channelizer.arm_fold.launches = 0
        fg.run(device="cuda")
        out[name] = (snk.data(), channelizer.arm_fold.launches)
    ref = out["channelizer"][0][:, DEC_CHANNEL]
    got, launches = out["decimator"]
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"pfb_decimator channel {DEC_CHANNEL}: {got.shape[0]} samples, max "
        f"err {err:.3e} of max|y| vs the channelizer's column (tol {DEC_TOL}); "
        f"arm_fold launches {launches}")
    require(got.shape == ref.shape and err <= DEC_TOL,
            "pfb_decimator disagrees with the channelizer")
    require(launches > 0, "K7 was never launched on the decimator path")
    return launches


def decimator_step(torch, card: str) -> float:
    """15. The step of phase 12's pfb_decimator graph (K7, then one
    channel's weighted sum), over a replayed batch into a null sink."""
    from newsched_tpu_torch import Flowgraph
    from newsched_tpu_torch.blocks import filter as filt, general

    taps, _ = design()
    fg = Flowgraph(batch_size=BATCH)
    blk = filt.pfb_decimator(M, DEC_CHANNEL, taps=taps)
    fg.connect(general.vector_source(fm_band(BATCH, "cuda"), repeat=True), 0,
               blk, 0)
    fg.connect(blk, 0, general.null_sink(dtype="cf32"), 0)
    return fg_step_rate(torch, fg, "pfb_decimator", card, BATCH, profile=True)


def gen_batches(torch, fm_chain, noise, consts, draws, step, **kw):
    """Two carried batches of the live chain from stream start: K5
    (``step`` = fm_chain_gen_step) or a composition (noise -> chain).
    Returns [aud, prev, tail, carry] per batch."""
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    carry, prev, tail = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
                         torch.zeros(A - 1, 2 * M, **z))
    outs = []
    for b in range(2):
        g = noise.group_tensor(b * ROWS // noise.GROUP_ROWS, "cuda")
        aud, prev, tail, carry = step(g, amp, carry, prev, tail, consts,
                                      DECIM, DEMOD_GAIN, ROWS, draws=draws, **kw)
        outs += [aud, prev, tail, carry]
    return outs


def composed(rows_fn, chain_fn):
    """A K5-shaped step from a noise generator and a chain step."""
    def step(g, amp, carry, prev, tail, consts, decim, gain, n, draws, **kw):
        rows = rows_fn(g, n_rows=n, width=2 * M, seed=0, device="cuda",
                       draws=draws, amp=amp)
        aud, prev, tail = chain_fn(rows, carry, prev, tail, consts, decim,
                                   gain, **kw)
        return aud, prev, tail, rows[-carry.shape[0]:].contiguous()
    return step


def phase_k5(torch, fm_chain, noise):
    """K5 against K4 -> K3, across tiles and against its plain version;
    returns (worst error vs plain, the two-draw stream's first audio)."""
    consts = chain_consts()
    worst = 0.0
    for draws in (3, 2):
        got = gen_batches(torch, fm_chain, noise, consts, draws,
                          fm_chain.fm_chain_gen_step)
        k4k3 = gen_batches(torch, fm_chain, noise, consts, draws,
                           composed(noise.gaussian_rows,
                                    fm_chain.fm_chain_step_planes), tile=128)
        require(all(torch.equal(a, b) for a, b in zip(got, k4k3)),
                f"K5 draws={draws}: differs from K4 * amp -> K3")
        for tile in (64, 256):
            other = gen_batches(torch, fm_chain, noise, consts, draws,
                                fm_chain.fm_chain_gen_step, tile=tile)
            require(all(torch.equal(a, b) for a, b in zip(got, other)),
                    f"K5 draws={draws}: tile {tile} differs from tile 128")
        plain = gen_batches(torch, fm_chain, noise, consts, draws,
                            fm_chain.fm_chain_gen_step_plain)
        # draws=3 is phase 7's stream: its golden's first two batches
        _, bad = (golden(noise_rows(torch, noise, 2, draws), "noise draws=2")
                  if draws == 2 else golden(None, "noise"))
        bad = bad[:2 * N_AUD]
        aud = torch.cat([got[0], got[4]]).cpu().numpy()
        aud_p = torch.cat([plain[0], plain[4]]).cpu().numpy()
        err = float(np.abs(aud - aud_p)[~bad].max())
        err_prev = max(float((got[i] - plain[i]).abs().max()) for i in (1, 5))
        err_carry = max(float((got[i] - plain[i]).abs().max()) for i in (3, 7))
        log(f"K5 fm_chain_gen_step draws={draws}: bit-equal to K4 * amp -> K3 "
            f"and across tiles 64/128/256; vs plain: audio {err:.3e} on "
            f"{int((~bad).sum())} unmasked samples, prev {err_prev:.3e}, "
            f"carry {err_carry:.3e} (tol {K5_TOL})")
        require(max(err, err_prev) <= K5_TOL and err_carry == 0.0,
                f"K5 draws={draws}: disagrees with its plain version")
        worst = max(worst, err, err_prev)
        if draws == 2:
            first_batch_d2 = got[0]
    return worst, first_batch_d2


def phase_live(torch, fm_chain, noise, fused_out, first_batch_d2) -> int:
    fg, blks = flowgraph("live", 4)
    fm_chain.fm_chain_gen_step.launches = 0
    fg.run(device="cuda")
    launches = fm_chain.fm_chain_gen_step.launches
    got = blks["sink"].data()
    log(f"launches on the live path: fm_chain_gen_step {launches}")
    require(launches > 0, "K5 was never launched on the live path")
    require(np.array_equal(got, fused_out),
            "live flowgraph differs from the fused noise-source flowgraph")
    gate(None, got, "live flowgraph (bit-equal to the noise-source "
         "flowgraph)", "noise")
    fg, blks = flowgraph("live", 1, noise_draws=2)
    fg.run(device="cuda")
    require(np.array_equal(blks["sink"].data(), first_batch_d2.cpu().numpy()),
            "two-draw live flowgraph differs from K5's first batch")
    log("live flowgraph noise_draws=2: bit-equal to K5's first batch")
    return launches


# -- config #1: the wideband-FM receiver ------------------------------------

WB_FS, WB_FC, WB_D, WB_RD, WB_DEV = 1e6, 200e3, 4, 5, 75e3
WB_TONE = 231_250.0        # 31.25 kHz into the 100 kHz channel
WB_BATCH = 2_088_960       # samples per batch (the reference bench's)
WB_R = WB_BATCH // 64      # folded rows per batch (32640)
WB_NAUD = WB_R // (WB_D * WB_RD)  # audio rows per batch (1632)
WB_GATE_DB = 60.0          # the reference's gate (bench.py wbfm gate)
K10_TOL = 2e-5             # K10/K12 vs plain: FMA vs separate roundings
# (tile, seg_group) of K10/K12 blocks, the default first
WB_GEOMS = ((2040, 4), (1920, 4), (1020, 4), (1360, 4), (4080, 2), (2040, 2),
            (2040, 8), (1020, 8), (4080, 1), (8160, 1), (680, 8), (1020, 2))


def wb_plan():
    from newsched_tpu_torch.ops import firdes, nco
    from newsched_tpu_torch.ops.cuda import wbfm_chain

    chan = firdes.low_pass(1.0, WB_FS, 100e3, 30e3)
    rt = firdes.low_pass(1.0, 1.0, 0.45 / WB_RD, 0.1 / WB_RD)
    plan = wbfm_chain.WbfmChainPlan(
        chan, nco.freq_to_dphase(WB_FC, WB_FS), WB_D, rt, WB_RD,
        (WB_FS / WB_D) / (2 * np.pi * WB_DEV))
    return plan, wbfm_chain.wbfm_consts(plan, "cuda"), chan, rt


def phase_k8_k11(torch, sources) -> dict:
    """K8 and K11 at the main path's shapes against their plain versions,
    on a tone with a nonzero phase and on phases a hair below a turn."""
    from newsched_tpu_torch.ops import nco

    dp = nco.freq_to_dphase(WB_TONE, WB_FS)
    errs = {}
    for ph0, dphase, what in ((0x89ABCDEF, dp, "tone"),
                              (0xFFFFFFFF, 0xFFFFFFFF, "quadrant 4")):
        got = sources.nco_planes(ph0, dphase, 0.8, WB_BATCH, "cuda")
        ref = sources.nco_planes_plain(ph0, dphase, 0.8, WB_BATCH, "cuda")
        fgot = sources.nco_folded(ph0, dphase, 0.8, WB_R, "cuda")
        fref = sources.nco_folded_plain(ph0, dphase, 0.8, WB_R, "cuda")
        e8 = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        e11 = float((fgot - fref).abs().max())
        log(f"K8 nco_planes ({WB_BATCH} samples = {WB_BATCH // 128} x 128 x 2), "
            f"K11 nco_folded ({WB_R} x 128), {what}: max abs err vs plain "
            f"{e8:.3e} / {e11:.3e} (bit-equal required)")
        require(all(torch.equal(g, r) for g, r in zip(got, ref))
                and torch.equal(fgot, fref), f"K8/K11 {what}: differ from plain")
        if what == "quadrant 4":
            # phases 2^32 - 1 - k: t = -(k+1)/2^32, cos ~ 1 and sin ~ 0-
            require(bool((got[0] > 0.79).all()) and bool((got[1] <= 0).all())
                    and float(got[1][:4096].abs().max()) < 1e-5,
                    "K8: phases below a whole turn left quadrant 0")
        errs["K8"] = max(errs.get("K8", 0.0), e8)
        errs["K11"] = max(errs.get("K11", 0.0), e11)
    return errs


def fm_signal(n: int, torch) -> torch.Tensor:
    """A broadcast-FM signal at the channel's centre: a 2 kHz tone at
    75 kHz deviation, complex64 on the GPU."""
    t = torch.arange(n, dtype=torch.float64, device="cuda") / WB_FS
    msg = torch.sin(2 * np.pi * 2000.0 * t)
    ph = torch.cumsum(2 * np.pi * (WB_DEV / WB_FS) * msg, 0) + 2 * np.pi * WB_FC * t
    return torch.polar(torch.ones_like(ph), ph).to(torch.complex64)


def phase_k10(torch, wbfm_chain) -> float:
    """K10 against its plain version on two carried batches, bit-identical
    across tiles, segment groups and a batch split."""
    plan, consts, _, _ = wb_plan()
    x = fm_signal(2 * WB_BATCH, torch)

    def run(step, sizes=(WB_BATCH, WB_BATCH), **kw):
        carry = torch.zeros(plan.B8, 128, device="cuda")
        outs, pos = [], 0
        for n in sizes:
            xp = wbfm_chain.fold_planes(x[pos:pos + n])
            aud, carry = step(xp, carry, plan, consts, **kw)
            outs.append(wbfm_chain.unfold_audio(aud))
            pos += n
        return torch.cat(outs), carry

    got, carry = run(wbfm_chain.wbfm_chain_step)
    ref, carry_p = run(wbfm_chain.wbfm_chain_step_plain)
    err = float((got - ref).abs().max())
    log(f"K10 wbfm_chain_step: 2 carried batches x {WB_R} x 128 rows on an FM "
        f"signal, max abs err vs plain {err:.3e} of max|audio| "
        f"{float(ref.abs().max()):.3f} (tol {K10_TOL}); carry equal: "
        f"{torch.equal(carry, carry_p)}")
    require(err <= K10_TOL and torch.equal(carry, carry_p),
            "K10: kernel disagrees with its plain version")
    for tile, gs in WB_GEOMS[1:]:
        other, _ = run(wbfm_chain.wbfm_chain_step, tile=tile, seg_group=gs)
        require(torch.equal(got, other),
                f"K10: tile {tile} / seg_group {gs} differs from the default")
    one, _ = run(wbfm_chain.wbfm_chain_step, sizes=(2 * WB_BATCH,))
    require(torch.equal(got, one),
            "K10: one batch of 2B differs from two carried batches of B")
    log(f"K10: tiles/segment groups {WB_GEOMS} and one batch of 2B give "
        f"bit-identical audio")
    return err


def live_batches(torch, sources, wbfm_chain, step_live: bool, plain=False):
    """Two carried batches of the live chain from stream start: K12 (or
    its plain version), or K11 -> K10."""
    from newsched_tpu_torch.ops import nco

    plan, consts, _, _ = wb_plan()
    dp = nco.freq_to_dphase(WB_TONE, WB_FS)
    carry = torch.zeros(plan.B8, 128, device="cuda")
    outs, ph = [], 0x12345678
    for b in range(2):
        if step_live:
            fn = (wbfm_chain.wbfm_chain_live_step_plain if plain
                  else wbfm_chain.wbfm_chain_live_step)
            outs.append(fn(ph, dp, 0.8, b == 0, plan, consts, WB_R))
        else:
            xp = sources.nco_folded(ph, dp, 0.8, WB_R, "cuda")
            aud, carry = wbfm_chain.wbfm_chain_step(xp, carry, plan, consts)
            outs.append(aud)
        ph = nco.nco_advance(ph, dp, WB_BATCH)
    return outs


def phase_k12(torch, sources, wbfm_chain) -> float:
    got = live_batches(torch, sources, wbfm_chain, True)
    two = live_batches(torch, sources, wbfm_chain, False)
    require(all(torch.equal(a, b) for a, b in zip(got, two)),
            "K12: differs from K11 -> K10")
    plain = live_batches(torch, sources, wbfm_chain, True, plain=True)
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    log(f"K12 wbfm_chain_live_step: 2 carried batches from stream start "
        f"(pre-stream zeros, then the uint32 wrap): bit-equal to K11 -> K10; "
        f"max abs err vs plain {err:.3e} (tol {K10_TOL})")
    require(err <= K10_TOL, "K12: kernel disagrees with its plain version")
    return err


def wb_graph(kind: str, n_batches, sink="vector", tone=WB_TONE,
             center=WB_FC, deemph_tau=None):
    """models.wbfm_receiver at config #1 on the fixed-point tone at WB_TONE:
    staged, fused (cf32 sig_source), folded (sig_source_folded) or live;
    de-emphasised with ``deemph_tau``."""
    from newsched_tpu_torch import models
    from newsched_tpu_torch.blocks import analog

    src = {"staged": None, "fused": None, "live": "live",
           "folded": analog.sig_source_folded(WB_FS, frequency=tone)}[kind]
    if src is None:
        src = analog.sig_source(WB_FS, "complex", frequency=tone)
    fg, blks = models.wbfm_receiver(
        fs=WB_FS, center_freq=center, quad_rate_decim=WB_D,
        audio_decim=(1, WB_RD), deviation=WB_DEV, source=src,
        batch_size=WB_BATCH, sink=sink, fused=kind != "staged",
        n_samples=None if n_batches is None else n_batches * WB_NAUD * 64,
        deemph_tau=deemph_tau)
    if kind == "live":
        blks["source"].set_frequency(tone)
    return fg, blks


def phase_wbfm_graphs(torch, sources, wbfm_chain) -> dict:
    """The four config #1 graphs, 4 batches each, against the float64
    golden; each path's launch counts."""
    from newsched_tpu_torch.ops import nco
    from newsched_tpu_torch.testing import fxpt_tone, snr_db, wbfm_golden

    _, _, chan, rt = wb_plan()
    n = 4 * WB_BATCH
    ref = wbfm_golden(fxpt_tone(n, nco.freq_to_dphase(WB_TONE, WB_FS)), chan,
                      nco.freq_to_dphase(WB_FC, WB_FS), WB_D, rt, WB_RD,
                      (WB_FS / WB_D) / (2 * np.pi * WB_DEV))
    kernels = {"K8": sources.nco_planes, "K11": sources.nco_folded,
               "K10": wbfm_chain.wbfm_chain_step,
               "K12": wbfm_chain.wbfm_chain_live_step}
    want = {"staged": ("K8",), "fused": ("K8", "K10"),
            "folded": ("K11", "K10"), "live": ("K12",)}
    out, launches, audio = {}, {}, {}
    for kind in ("staged", "fused", "folded", "live"):
        fg, blks = wb_graph(kind, 4)
        for k in kernels.values():
            k.launches = 0
        fg.run(device="cuda")
        counts = {name: k.launches for name, k in kernels.items()}
        got = blks["sink"].data()
        require(got.shape == (n // 20,) and bool(np.isfinite(got).all()),
                f"wbfm {kind}: audio shape {got.shape} or non-finite")
        snr = snr_db(ref[:len(got)], got)
        log(f"wbfm {kind} flowgraph: {len(got)} audio samples, SNR vs float64 "
            f"golden {snr:.2f} dB (gate {WB_GATE_DB} dB); launches {counts}")
        require(snr >= WB_GATE_DB, f"wbfm {kind}: SNR {snr:.2f} dB < gate")
        require(all(counts[k] > 0 for k in want[kind]),
                f"wbfm {kind}: a kernel of the path was never launched")
        out[kind] = snr
        launches[kind] = counts
        audio[kind] = got
    return {"snr": out, "launches": launches, "audio": audio, "ref": ref}


def wb_step_rate(torch, kind: str, card: str) -> float:
    fg, _ = wb_graph(kind, None, sink="null")
    return fg_step_rate(torch, fg, f"wbfm {kind}", card, WB_BATCH)


# -- config #0: the FIR chain, and K3's pipelined form -----------------------

FIR_FS, FIR_FREQ, FIR_NTAPS = 1e6, 123_456.0, 128
FIR_BATCH = 1 << 21        # samples per batch
FIR_R = FIR_BATCH // 64    # folded rows per batch (32768)
FIR_N = 10_000_000         # the reference's gate as written (tests/test_models.py)
FIR_GATE_DB = 60.0         # the reference's gate (bench.py config #0)
K9_TOL = 2e-5              # K9 vs plain, relative to max|out|: FMA, another order
# (tile, seg_group) of K9 blocks, the default first (8 segments a block or
# more: a row's lanes of a block are whole 32-byte sectors)
K9_GEOMS = ((512, 8), (256, 8), (1024, 8), (512, 16), (1024, 16), (256, 32),
            (128, 64))
K9_R_ODD = 32700           # folded rows that L = 128 does not divide
K3P_GS = (1, 2, 4)         # tiles a K3p block walks, beside its default


def fir_taps(torch):
    """Config #0's taps, and K9's constants on the card (the taps and the
    FFT convolution's table; the plain version reads the taps)."""
    from newsched_tpu_torch.ops import firdes
    from newsched_tpu_torch.ops.cuda import fir_source

    taps = firdes.low_pass(1.0, FIR_FS, 0.2 * FIR_FS, 0.05 * FIR_FS,
                           ntaps=FIR_NTAPS)
    return taps, fir_source.fir_tone_consts(taps, "cuda")


def k9_run(torch, fir_source, step, D, sizes=(FIR_BATCH, FIR_BATCH),
           ph=0, first=True):
    """Consecutive batches of the live filtered tone from phase ``ph``
    through ``step`` (K9, its plain version, or K9 at a geometry): the
    unfolded cf32 stream."""
    from newsched_tpu_torch.ops import nco

    _, taps = fir_taps(torch)
    dp = nco.freq_to_dphase(FIR_FREQ, FIR_FS)
    outs = []
    for n in sizes:
        outs.append(fir_source.unfold_complex(
            step(ph, dp, 0.8, first, taps, D, n // 64)))
        ph, first = nco.nco_advance(ph, dp, n), False
    return torch.cat(outs)


def k9_at(fir_source, tile: int, gs: int):
    """K9 at a block geometry (tile rows, segments a block)."""
    def step(ph, dp, amp, first, taps, D, R):
        g = fir_source._geometry(R, D, FIR_NTAPS, tile, gs)
        return fir_source._launch(ph, dp, amp, first, taps, D, R, g)
    return step


def phase_k9(torch, fir_source) -> float:
    """K9 at 2^21 samples against its plain version (D = 1 and 4, two
    batches from stream start and one from a nonzero phase), bit-identical
    across block geometries and across a batch split."""
    worst = 0.0
    for D in (1, 4):
        for ph, first, nb in ((0, True, 2), (0x9E3779B9, False, 1)):
            sizes = (FIR_BATCH,) * nb
            got = k9_run(torch, fir_source, fir_source.fir_tone_step, D, sizes,
                         ph, first)
            ref = k9_run(torch, fir_source, fir_source.fir_tone_step_plain, D,
                         sizes, ph, first)
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            log(f"K9 fir_tone_step D={D}, {nb} batch(es) of {FIR_BATCH} from "
                f"phase {ph:#x}{' (stream start)' if first else ''}: max abs "
                f"err vs plain {err:.3e} = {err / scale:.3e} of max|out| "
                f"{scale:.4f} (tol {K9_TOL})")
            require(err <= K9_TOL * scale and got.shape == ref.shape,
                    f"K9 D={D}: kernel disagrees with its plain version")
            worst = max(worst, err)
    # R that L does not divide: a segment's first and last transforms reach
    # past its rows, and its blocks' tiles
    sizes = (64 * K9_R_ODD,)
    got = k9_run(torch, fir_source, fir_source.fir_tone_step, 1, sizes,
                 0xFFFFF000, True)
    ref = k9_run(torch, fir_source, fir_source.fir_tone_step_plain, 1, sizes,
                 0xFFFFF000, True)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    log(f"K9 fir_tone_step at R = {K9_R_ODD} (not a multiple of L = 128): "
        f"max abs err vs plain {err:.3e} = {err / scale:.3e} of max|out| "
        f"(tol {K9_TOL})")
    require(err <= K9_TOL * scale and got.shape == ref.shape,
            f"K9 R={K9_R_ODD}: kernel disagrees with its plain version")
    worst = max(worst, err)
    base = k9_run(torch, fir_source, fir_source.fir_tone_step, 1)
    for tile, gs in K9_GEOMS[1:]:
        require(torch.equal(base, k9_run(torch, fir_source,
                                         k9_at(fir_source, tile, gs), 1)),
                f"K9: tile {tile} / seg_group {gs} differs from the default")
    half = k9_run(torch, fir_source, fir_source.fir_tone_step, 1,
                  (FIR_BATCH // 2,) * 4)
    require(torch.equal(base, half),
            "K9: four batches of 2^20 differ from two batches of 2^21")
    log(f"K9: geometries {K9_GEOMS} and batches of 2^20 give bit-identical "
        f"output")
    return worst


def fir_graph(kind: str, n, sink="vector"):
    from newsched_tpu_torch import models

    return models.fir_chain(n_samples=n, fs=FIR_FS, ntaps=FIR_NTAPS,
                            frequency=FIR_FREQ, batch_size=FIR_BATCH, sink=sink,
                            source="live" if kind == "live" else None)


def phase_fir_graphs(torch, sources, fir_source) -> dict:
    """Config #0 staged (K8 -> fir_filter -> head) and live (K9 -> head) at
    10M samples in batches of 2^21 (the last cut by the head), against the
    float64 golden and each other; each path's launch counts."""
    from newsched_tpu_torch.testing import fir_golden, snr_db

    taps, _ = fir_taps(torch)
    ref = fir_golden(FIR_N, taps, FIR_FREQ, FIR_FS)
    kernels = {"K8": sources.nco_planes, "K9": fir_source.fir_tone_step}
    want = {"staged": "K8", "live": "K9"}
    out, snr, launches = {}, {}, {}
    for kind in ("staged", "live"):
        fg, blks = fir_graph(kind, FIR_N)
        for k in kernels.values():
            k.launches = 0
        fg.run(device="cuda")
        counts = {name: k.launches for name, k in kernels.items()}
        got = blks["sink"].data()
        require(got.shape == (FIR_N,)
                and bool(np.isfinite(got.view(np.float32)).all()),
                f"fir_chain {kind}: output shape {got.shape} or non-finite")
        snr[kind] = snr_db(ref, got)
        log(f"fir_chain {kind} flowgraph: {FIR_N} samples in batches of "
            f"{FIR_BATCH}, SNR vs float64 golden {snr[kind]:.2f} dB (gate "
            f"{FIR_GATE_DB} dB; the CPU tests hold it above 100); launches "
            f"{counts}")
        require(snr[kind] >= FIR_GATE_DB, f"fir_chain {kind}: SNR below gate")
        require(counts[want[kind]] > 0,
                f"fir_chain {kind}: {want[kind]} was never launched")
        out[kind], launches[kind] = got, counts
    cross = snr_db(out["staged"], out["live"])
    log(f"fir_chain live vs staged: {cross:.2f} dB (> 100 required)")
    require(cross > 100, "fir_chain: live and staged disagree")
    return {"snr": snr, "launches": launches, "out": out, "ref": ref}


def phase_k3p(torch, fm_chain) -> dict:
    """K3p (fm_chain_step_planes(pipelined=True)) on two carried batches of
    the FM band, counted: bit-equal to K3, and bit-identical across tiles
    and tiles per block."""
    consts = chain_consts()
    rows = band_rows(torch)
    k3 = k3_batches(torch, fm_chain, consts, rows, fm_chain.fm_chain_step_planes)
    fm_chain.fm_chain_step_planes.pipe_launches = 0
    got = k3_batches(torch, fm_chain, consts, rows,
                     fm_chain.fm_chain_step_planes, pipelined=True)
    launches = fm_chain.fm_chain_step_planes.pipe_launches
    require(launches > 0, "K3p was never launched by pipelined=True")
    require(all(torch.equal(a, b) for a, b in zip(got, k3)),
            "K3p: audio, prev or tail differ from K3")
    for tile in (128, 64):
        for G in K3P_GS:
            other = k3_batches(torch, fm_chain, consts, rows, fm_chain._pipe,
                               tile=tile, tiles_per_block=G)
            require(all(torch.equal(a, b) for a, b in zip(got, other)),
                    f"K3p: tile {tile}, {G} tiles a block differs")
    other = k3_batches(torch, fm_chain, consts, rows,
                       fm_chain.fm_chain_step_planes, pipelined=True, tile=128)
    require(all(torch.equal(a, b) for a, b in zip(got, other)),
            "K3p: tile 128 differs from the default tile 64")
    err = max(float((g - r).abs().max()) for g, r in zip(
        got, k3_batches(torch, fm_chain, consts, rows,
                        fm_chain.fm_chain_step_planes_plain)))
    log(f"K3p fm_chain_step_planes(pipelined=True): 2 batches x {ROWS} rows, "
        f"bit-equal to K3 (audio, prev, tail), bit-identical at tiles 128/64 "
        f"x {K3P_GS} tiles a block; max abs err vs plain {err:.3e}; "
        f"launches {launches}")
    require(err <= K3_TOL, "K3p: disagrees with the plain version")
    return {"launches": launches, "err": err}


def fir_step_rate(torch, kind: str, card: str) -> float:
    fg, _ = fir_graph(kind, FIR_N, sink="null")
    return fg_step_rate(torch, fg, f"fir_chain {kind}", card, FIR_BATCH)


# -- sharding: logical shards on the one card --------------------------------

MESHES = (4, 8)            # logical shards of the sharded graphs
K6_ROWS = ROWS // 4        # rows of a shard of a 4-shard batch (8192)
K6_NLOC = tuple(ROWS // n for n in MESHES)  # a shard's rows: 8192, 4096
K6_WARM = 512              # the reference's warm at both (its tile)


def phase_k6(torch, fm_chain, noise) -> float:
    """K6 at a shard's rows against K5's stream at the same rows (bit for
    bit) and its plain version (K5_TOL off the branch cut), at the rows of
    a shard of the 4- and the 8-shard live path (the second window a prefix
    of the first). K5 runs one batch of ROWS rows with zero state from 3
    shards below the shard (at stream start for the first): its blocks
    reach 80 rows back at most, so from there on it is the true stream.
    Then K6 over the 4 and the 8 shards of that batch in one launch (nd),
    bit-equal to the shards' calls one by one, and from stream start to K5
    over the whole batch. Returns the worst error."""
    consts = chain_consts()
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    worst = 0.0
    for draws in (3, 2):
        for where, base, off in (("stream start", 0, 0),
                                 ("shard 3", 3 * K6_ROWS // 64, 3 * K6_ROWS),
                                 ("group 2^32-2", (1 << 32) - 2, 3 * K6_ROWS)):
            b0 = base - off // noise.GROUP_ROWS
            k5 = fm_chain.fm_chain_gen_step(
                noise.group_tensor(b0, "cuda"), amp,
                torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
                torch.zeros(A - 1, 2 * M, **z), consts, DECIM, DEMOD_GAIN, ROWS,
                draws=draws)[0]
            if b0 == 0:  # phases 7 and 13's goldens of this stream
                _, bad = golden(None, "noise" if draws == 3 else "noise draws=2")
                bad = bad[off // DECIM:]
            else:  # the shard's window and 1024 rows of lead, as far back
                lead = 1024  # as any output reaches (A + L - 1 = 80 rows)
                rows = noise.gaussian_rows_plain(
                    base, n_rows=lead + K6_ROWS, width=2 * M, seed=0,
                    device="cuda", draws=draws, row0=-lead) * 0.5
                _, bad = golden(rows.cpu().numpy(), f"{where} draws={draws}")
                bad = bad[lead // DECIM:]
            for n_loc in K6_NLOC:
                # the base from the card: the batch's counter and the
                # shard's offset in groups, as the sharded source passes it
                got = fm_chain.fm_chain_gen_warm_step(
                    noise.group_tensor(b0, "cuda"), amp, consts, DECIM,
                    DEMOD_GAIN, n_loc, warm=K6_WARM, draws=draws,
                    goff=off // noise.GROUP_ROWS)
                plain = fm_chain.fm_chain_gen_warm_step_plain(
                    base, amp, consts, DECIM, DEMOD_GAIN, n_loc, K6_WARM,
                    draws=draws)
                require(torch.equal(got, k5[off // DECIM:(off + n_loc) // DECIM]),
                        f"K6 at {where}, {n_loc} rows, draws={draws}: differs "
                        f"from K5's stream")
                keep = ~bad[:n_loc // DECIM]
                err = float(np.abs(got.cpu().numpy()
                                   - plain.cpu().numpy())[keep].max())
                log(f"K6 fm_chain_gen_warm_step at {where} (base group "
                    f"{base}), {n_loc} rows, draws={draws}: "
                    f"bit-equal to K5's stream there; vs plain {err:.3e} on "
                    f"{int(keep.sum())} unmasked samples (tol {K5_TOL})")
                require(err <= K5_TOL, f"K6 at {where}, {n_loc} rows: "
                        f"disagrees with its plain version")
                worst = max(worst, err)
            for nd in MESHES:  # the batch's shards, one launch
                n_loc = ROWS // nd
                before = fm_chain.fm_chain_gen_warm_step.launches
                got = fm_chain.fm_chain_gen_warm_step(
                    noise.group_tensor(b0, "cuda"), amp, consts, DECIM,
                    DEMOD_GAIN, n_loc, warm=K6_WARM, draws=draws, nd=nd)
                one = fm_chain.fm_chain_gen_warm_step.launches == before + 1
                per = torch.cat([fm_chain.fm_chain_gen_warm_step(
                    noise.group_tensor(b0, "cuda"), amp, consts, DECIM,
                    DEMOD_GAIN, n_loc, warm=K6_WARM, draws=draws,
                    goff=d * n_loc // noise.GROUP_ROWS) for d in range(nd)])
                # K5 ran from zero state: the true stream only at its start
                k5_eq = b0 != 0 or torch.equal(got, k5)
                require(one and torch.equal(got, per) and k5_eq,
                        f"K6 over {nd} shards from base group {b0}, "
                        f"draws={draws}: not one launch, or differs from the "
                        f"shards one by one or from K5's stream")
                log(f"K6 over {nd} shards of {n_loc} rows in one launch from "
                    f"base group {b0}, draws={draws}: bit-equal to the "
                    f"{nd} shards one by one"
                    + (" and to K5's batch" if b0 == 0 else ""))
    return worst


def phase_sharded_live(fm_chain, live_out: np.ndarray) -> int:
    """The live flowgraph over 4 and 8 shards: bit-equal to the unsharded
    one, gated against its golden; K6 launched once a batch (one grid over
    the shards), K5 never. Returns K6's launches."""
    from newsched_tpu_torch.parallel import make_mesh

    total = 0
    for n in MESHES:
        fg, blks = flowgraph("live", 3)
        fm_chain.fm_chain_gen_warm_step.launches = 0
        fm_chain.fm_chain_gen_step.launches = 0
        fg.run(device="cuda", mesh=make_mesh(n))
        k6, k5 = (fm_chain.fm_chain_gen_warm_step.launches,
                  fm_chain.fm_chain_gen_step.launches)
        got = blks["sink"].data()
        log(f"launches on the live path, {n} shards: fm_chain_gen_warm_step "
            f"{k6}, fm_chain_gen_step {k5}")
        require(k6 == 3 and k5 == 0,
                f"live on {n} shards: K6 not once a batch, or K5 ran")
        require(np.array_equal(got, live_out[:3 * N_AUD]),
                f"live on {n} shards differs from the unsharded flowgraph")
        gate(None, got, f"live flowgraph on {n} shards (bit-equal to the "
             f"unsharded one)", "noise", n_batches=3)
        total += k6
    return total


def phase_sharded_fused(torch, fm_chain, rows: np.ndarray,
                        replay_out: np.ndarray) -> tuple[int, float]:
    """The fused flowgraph over the replayed stream on 4 and 8 shards:
    bit-equal to the unsharded one, gated; K3 launched once a batch. Then
    K3 with warm > 0 over the batch's shards in one launch against its
    shards' calls one by one (bit for bit), the unsharded stream and its
    plain version with nd= (K3_TOL off the branch cut); on shard 1 of each
    mesh, K3 with warm > 0 against its plain version and the unsharded
    stream, and K3p with warm > 0 against K3. Returns K3's launches with
    warm > 0 and the worst error against the plain version."""
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh

    total = 0
    for n in MESHES:
        fg, blks = flowgraph(general.vector_source(rows, repeat=True), 3)
        fm_chain.fm_chain_step_planes.launches = 0
        fg.run(device="cuda", mesh=make_mesh(n))
        k3 = fm_chain.fm_chain_step_planes.launches
        got = blks["sink"].data()
        log(f"launches on the fused path, {n} shards: fm_chain_step_planes {k3}")
        require(k3 == 3, f"fused on {n} shards: K3 not once a batch")
        require(np.array_equal(got, replay_out[:3 * N_AUD]),
                f"fused on {n} shards differs from the unsharded flowgraph")
        gate(np.concatenate([rows] * 4), got, f"fused flowgraph on {n} shards "
             f"(bit-equal to the unsharded one)", "replay", n_batches=3)
        total += k3
    H8 = fm_chain._round8(L - 1)
    consts = chain_consts()
    vb_all = torch.from_numpy(rows).cuda()
    z = dict(dtype=torch.float32, device="cuda")
    hr = K6_WARM + H8
    _, bad = golden(None, "replay")
    worst = 0.0
    z1, zt = torch.zeros(1, 2 * M, **z), torch.zeros(A - 1, 2 * M, **z)
    halo0 = torch.zeros(hr, 2 * M, **z)  # stream start
    vp = torch.cat([halo0, vb_all])
    keep = ~bad[:N_AUD]
    for n_dev, n_loc in zip(MESHES, K6_NLOC):
        # the batch's n_dev shards in one launch, as the sharded graph
        # launches K3: against the shards one by one, each after the warm
        # + H8 rows before it, and the plain version's shards
        before = fm_chain.fm_chain_step_planes.launches
        one = fm_chain.fm_chain_step_planes(
            vb_all, halo0, z1, zt, consts, DECIM, DEMOD_GAIN, warm=K6_WARM,
            tile=128, nd=n_dev)[0]
        once = fm_chain.fm_chain_step_planes.launches == before + 1
        per = torch.cat([fm_chain.fm_chain_step_planes(
            vb_all[d * n_loc:(d + 1) * n_loc], vp[d * n_loc:d * n_loc + hr],
            z1, zt, consts, DECIM, DEMOD_GAIN, warm=K6_WARM, tile=128)[0]
            for d in range(n_dev)])
        plain = fm_chain.fm_chain_step_planes_plain(
            vb_all, halo0, z1, zt, consts, DECIM, DEMOD_GAIN, K6_WARM,
            nd=n_dev)[0]
        require(once and torch.equal(one, per),
                f"K3 warm > 0 over {n_dev} shards: not one launch, or "
                f"differs from the shards one by one")
        require(np.array_equal(one.cpu().numpy(), replay_out[:N_AUD]),
                f"K3 warm > 0 over {n_dev} shards differs from the unsharded "
                f"stream")
        err = float(np.abs(one.cpu().numpy()
                           - plain.cpu().numpy())[keep].max())
        log(f"K3 with warm={K6_WARM} over the {n_dev} shards of a batch in "
            f"one launch: bit-equal to the {n_dev} shards one by one and to "
            f"the unsharded stream; vs plain (nd={n_dev}) {err:.3e} on "
            f"{int(keep.sum())} unmasked samples (tol {K3_TOL})")
        require(err <= K3_TOL, f"K3 warm > 0 over {n_dev} shards: disagrees "
                f"with its plain version")
        worst = max(worst, err)
    for n_dev, n_loc in zip(MESHES, K6_NLOC):
        args = (vb_all[n_loc:2 * n_loc], vb_all[n_loc - hr:n_loc],
                torch.zeros(1, 2 * M, **z), torch.zeros(A - 1, 2 * M, **z),
                consts, DECIM, DEMOD_GAIN)
        shard = fm_chain.fm_chain_step_planes(*args, warm=K6_WARM)
        plain = fm_chain.fm_chain_step_planes_plain(*args, warm=K6_WARM)
        piped = fm_chain.fm_chain_step_planes(*args, warm=K6_WARM,
                                              pipelined=True)
        sl = slice(n_loc // DECIM, 2 * n_loc // DECIM)
        require(all(torch.equal(a, b) for a, b in zip(shard, piped)),
                f"K3p with warm > 0 differs from K3 ({n_loc} rows)")
        require(np.array_equal(shard[0].cpu().numpy(), replay_out[sl]),
                f"K3 with warm > 0 differs from the unsharded stream "
                f"({n_loc} rows)")
        keep = ~bad[sl]
        err = float(np.abs(shard[0].cpu().numpy()
                           - plain[0].cpu().numpy())[keep].max())
        log(f"K3 with warm={K6_WARM} on shard 1 of {n_dev} ({n_loc} rows): "
            f"vs plain {err:.3e} on {int(keep.sum())} unmasked samples (tol "
            f"{K3_TOL}); K3p bit-equal to it, both bit-equal to the "
            f"unsharded stream")
        require(err <= K3_TOL, f"K3 with warm > 0 ({n_loc} rows): disagrees "
                f"with its plain version")
        worst = max(worst, err)
    return total, worst


def shard_kernels_vs_plain(torch, wbfm_chain, fir_source, n: int) -> dict:
    """K10, K12, K9 and K9's partitioned instance over the n shards of a
    batch in one launch, as the sharded blocks launch them (K10 from a
    zero carry, each shard from the one before's boundary rows; K12 and K9
    at each shard's phase offset, stream start on shard 0 only): each one
    launch, bit-equal to its shards' calls one by one, and against its
    plain version with nd=: K10_TOL (carry equal), K10_TOL, K9_TOL of
    max|out|. Returns each kernel's worst error."""
    from newsched_tpu_torch.ops import nco

    plan, consts, _, _ = wb_plan()
    seg = WB_BATCH // n
    x = fm_signal(WB_BATCH, torch)
    dp = nco.freq_to_dphase(WB_TONE, WB_FS)
    dp9 = nco.freq_to_dphase(FIR_FREQ, FIR_FS)
    _, taps = fir_taps(torch)
    taps_p = wide_taps(torch, 1024)[1]
    carry0 = torch.zeros(plan.B8, 128, device="cuda")
    ph = 0x12345678

    def once(fn, counter, attr="launches"):
        before = getattr(counter, attr)
        out = fn()
        require(getattr(counter, attr) == before + 1,
                f"{counter.__name__}.{attr}: not one launch over {n} shards")
        return out

    xp = wbfm_chain.fold_planes(x, n)
    aud, carry = once(lambda: wbfm_chain.wbfm_chain_step(
        xp, carry0, plan, consts, nd=n), wbfm_chain.wbfm_chain_step)
    ref, carry_p = wbfm_chain.wbfm_chain_step_plain(xp, carry0, plan, consts,
                                                    nd=n)
    per, c = [], carry0
    for d in range(n):
        a, c = wbfm_chain.wbfm_chain_step(wbfm_chain.fold_planes(
            x[d * seg:(d + 1) * seg]), c, plan, consts)
        per.append(a)
    got = {"K10": (aud, ref, torch.cat(per))}
    require(torch.equal(carry, carry_p) and torch.equal(carry, c),
            f"K10 over {n} shards: carry differs")
    args = (ph, dp, 0.8, True, plan, consts, seg // 64)
    got["K12"] = (
        once(lambda: wbfm_chain.wbfm_chain_live_step(*args, nd=n),
             wbfm_chain.wbfm_chain_live_step),
        wbfm_chain.wbfm_chain_live_step_plain(*args, nd=n),
        torch.cat([wbfm_chain.wbfm_chain_live_step(*args, shard=d)
                   for d in range(n)]))
    for kid, tp, attr in (("K9", taps, "launches"),
                          ("K9p", taps_p, "partitioned_launches")):
        args = (0, dp9, 0.8, True, tp, 1, FIR_R // n)
        got[kid] = (
            once(lambda: fir_source.fir_tone_step(*args, nd=n),
                 fir_source.fir_tone_step, attr),
            fir_source.fir_tone_step_plain(*args, nd=n),
            torch.cat([fir_source.fir_tone_step(*args, shard=d)
                       for d in range(n)]))
    errs = {}
    for kid, (one, ref, per) in got.items():
        require(torch.equal(one, per), f"{kid} over {n} shards in one launch "
                f"differs from the shards one by one")
        errs[kid] = float((one - ref).abs().max())
        tol = (K9_TOL * float(ref.abs().max()) if kid.startswith("K9")
               else K10_TOL)
        require(errs[kid] <= tol, f"{kid} over {n} shards: disagrees with its "
                f"plain version")
    log(f"one launch over {n} shards: K10 ({seg // 64} rows a shard), K12, "
        f"K9 and K9 at 1024 taps ({FIR_R // n} rows a shard) each bit-equal "
        f"to its shards one by one; vs plain (nd={n}) max abs err "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol {K10_TOL}, {K10_TOL}, {K9_TOL} of max|out|)")
    return errs


def phase_sharded_receivers(torch, sources, wbfm_chain, fir_source, wb: dict,
                            fir: dict) -> tuple[dict, dict]:
    """The wbfm fused (sig_source K8 -> K10) and live (K12) graphs and the
    live fir_chain (K9) on 4 and 8 shards, 3 batches: bit-equal to their
    unsharded graphs, >= 60 dB; each kernel launched once a batch over
    every shard. Then K10, K12 and K9's two instances over each mesh's
    shards in one launch against their shards one by one and their plain
    versions. Returns the launches and each kernel's worst error."""
    from newsched_tpu_torch.parallel import make_mesh
    from newsched_tpu_torch.testing import snr_db

    kernels = {"K8": sources.nco_planes, "K10": wbfm_chain.wbfm_chain_step,
               "K12": wbfm_chain.wbfm_chain_live_step,
               "K9": fir_source.fir_tone_step}
    launches: dict = {}
    for n in MESHES:
        for kind in ("wbfm fused", "wbfm live", "fir_chain live"):
            if kind.startswith("wbfm"):
                form = kind.split()[1]
                fg, blks = wb_graph(form, 3)
                unsharded, ref, gate_db = wb["audio"][form], wb["ref"], WB_GATE_DB
                want = ({"K8": 3, "K10": 3} if form == "fused"
                        else {"K12": 3})
            else:
                fg, blks = fir_graph("live", 3 * FIR_BATCH)
                unsharded, ref = fir["out"]["live"], fir["ref"]
                gate_db, want = FIR_GATE_DB, {"K9": 3}
            for k in kernels.values():
                k.launches = 0
            fg.run(device="cuda", mesh=make_mesh(n))
            counts = {name: k.launches for name, k in kernels.items()}
            got = blks["sink"].data()
            snr = snr_db(ref[:len(got)], got)
            log(f"{kind} flowgraph on {n} shards: {len(got)} samples, "
                f"bit-equal to the unsharded one; SNR vs float64 golden "
                f"{snr:.2f} dB (gate {gate_db} dB); launches {counts}")
            require(len(got) > 0 and np.array_equal(got, unsharded[:len(got)]),
                    f"{kind} on {n} shards differs from the unsharded graph")
            require(snr >= gate_db, f"{kind} on {n} shards: SNR below gate")
            require(all(counts[k] == v for k, v in want.items()),
                    f"{kind} on {n} shards: launches {counts}, want {want}")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    errs: dict = {}
    for n in MESHES:
        for k, e in shard_kernels_vs_plain(torch, wbfm_chain, fir_source,
                                           n).items():
            errs[k] = max(errs.get(k, 0.0), e)
    return launches, errs


def phase_sharded_steps(card: str) -> list:
    """29b. The graph-mode steps (the bench's two-point fit, CUDA events)
    of the #2 fused replay (K3 at warm > 0), #1 fused (K8 -> K10), #1
    live (K12) and #0 live (K9) graphs unsharded and on 4 and 8 shards,
    each sharded graph in its one launch a batch and in the per-shard loop
    it ran before (probes/stages.py, a cut copy), in turns (forward, then
    backward); the best of each beside the unsharded step."""
    from newsched_tpu_torch.probes import stages

    t0 = time.monotonic()
    recs = stages.sharded_steps(shards=MESHES)
    one = {r["cell"]: r["ms"] for r in recs if r["shards"] == 1}
    for r in recs:
        log(f"sharded step, {r['cell']}, {r['shards']} shard(s), "
            f"{r['form']}: graph mode {r['ms']:.4f} ms a step (runs "
            + ", ".join(f"{m:.4f}" for m in r["ms_all"])
            + f"), {r['ms'] / one[r['cell']]:.3f}x the unsharded step "
            f"{one[r['cell']]:.4f} [{card}]")
    log(f"phase 29b: {time.monotonic() - t0:.1f} s")
    return recs


# -- graph mode: the runner's captured chunks against its loop ---------------

def launch_counts() -> dict:
    """Every kernel's launch count on the flowgraph paths, by name."""
    from newsched_tpu_torch.ops.cuda import launch_counters

    return {f"{f.__name__}.{a}": getattr(f, a) for f, a in launch_counters()}


def zero_launches() -> None:
    from newsched_tpu_torch.ops.cuda import launch_counters

    for f, a in launch_counters():
        setattr(f, a, 0)


def graph_vs_loop(build, label: str, want, mesh=None):
    """A graph of 2C + 1 batches (C = GRAPH_CHUNK: two replays of the
    captured chunk and a remainder) run by fg.run() on the card, which
    takes graph mode, and by Runner._run_loop: bit-equal, with the same
    launch counts, each kernel of ``want`` among them. Returns the graph
    mode's output and counts."""
    from newsched_tpu_torch.runtime import runner as rt

    nb = 2 * rt.GRAPH_CHUNK + 1
    out, counts = {}, {}
    for mode in ("graph", "loop"):
        fg, blks = build(nb)
        zero_launches()
        if mode == "graph":
            r = fg.run(device="cuda", mesh=mesh)
            require(r._chunk is not None and r._chunk.graph is not None,
                    f"{label}: fg.run() did not capture a graph")
        else:
            fg.validate()
            r = rt.Runner(fg, device="cuda", batch_size=fg.batch_size,
                          mesh=mesh)
            r._run_loop(r.cfg.n_batches)
        require(r.cfg.n_batches == nb, f"{label}: {r.cfg.n_batches} batches")
        counts[mode] = {k: v for k, v in launch_counts().items() if v}
        out[mode] = blks["sink"].data()
    log(f"graph mode, {label}: {nb} batches (chunks of {rt.GRAPH_CHUNK} "
        f"replayed twice, {nb % rt.GRAPH_CHUNK} stepped), bit-equal to the "
        f"loop: {np.array_equal(out['graph'], out['loop'])}; launches "
        f"{counts['graph']}")
    require(out["graph"].shape == out["loop"].shape
            and np.array_equal(out["graph"], out["loop"]),
            f"{label}: graph mode differs from the loop")
    require(counts["graph"] == counts["loop"],
            f"{label}: graph-mode launches {counts['graph']} != loop's "
            f"{counts['loop']}")
    require(all(counts["graph"].get(k, 0) > 0 for k in want),
            f"{label}: a kernel of the path ({want}) was never launched")
    return out["graph"], counts["graph"]


def phase_graph_mode(rows: np.ndarray, wb: dict, fir: dict) -> dict:
    """30. Every unsharded graph and the 4-shard live and fused graphs in
    graph mode against the loop, bit for bit, and above their gates on
    the batches the goldens cover; returns each path's launches."""
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh
    from newsched_tpu_torch.testing import snr_db

    K3, K4 = "fm_chain_step_planes.launches", "gaussian_rows.launches"
    K1, K5 = "arm_fold_dft.launches", "fm_chain_gen_step.launches"
    K6 = "fm_chain_gen_warm_step.launches"
    K8, K11 = "nco_planes.launches", "nco_folded.launches"
    K10, K12 = "wbfm_chain_step.launches", "wbfm_chain_live_step.launches"
    K9 = "fir_tone_step.launches"
    launches, outs = {}, {}
    replay = lambda nb: flowgraph(general.vector_source(rows, repeat=True), nb)
    for label, build, want, key, gate_db in (
            ("#2 fused replay", replay, (K3,), "replay", SNR_GATE_DB),
            ("#2 fused noise", lambda nb: flowgraph(None, nb), (K3, K4),
             "noise", SNR_GATE_DB),
            ("#2 staged", lambda nb: flowgraph(None, nb, fused=False),
             (K1, K4), "staged", STAGED_GATE_DB),
            ("#2 live", lambda nb: flowgraph("live", nb), (K5,), "noise",
             SNR_GATE_DB)):
        got, launches[label] = graph_vs_loop(build, label, want)
        gate(None, got[:4 * N_AUD], f"{label} in graph mode", key, gate_db,
             n_batches=4)
        outs[label] = got
    require(np.array_equal(outs["#2 live"], outs["#2 fused noise"]),
            "graph mode: live differs from the fused noise graph")
    for label, build, want, ref in (
            ("#2 live, 4 shards", lambda nb: flowgraph("live", nb), (K6,),
             outs["#2 live"]),
            ("#2 fused replay, 4 shards", replay, (K3,),
             outs["#2 fused replay"])):
        got, launches[label] = graph_vs_loop(build, label, want, make_mesh(4))
        require(np.array_equal(got, ref),
                f"{label}: differs from the unsharded graph mode")
    for kind, want in (("staged", (K8,)), ("fused", (K8, K10)),
                       ("folded", (K11, K10)), ("live", (K12,))):
        label = f"#1 {kind}"
        got, launches[label] = graph_vs_loop(
            lambda nb, kind=kind: wb_graph(kind, nb), label, want)
        n = 4 * WB_BATCH // 20
        snr = snr_db(wb["ref"][:n], got[:n])
        log(f"{label} in graph mode: SNR vs float64 golden {snr:.2f} dB on "
            f"the first 4 batches (gate {WB_GATE_DB})")
        require(snr >= WB_GATE_DB, f"{label}: below the gate")
    for kind, want in (("staged", (K8,)), ("live", (K9,))):
        label = f"#0 {kind}"
        got, launches[label] = graph_vs_loop(
            lambda nb, kind=kind: fir_graph(kind, nb * FIR_BATCH), label, want)
        snr = snr_db(fir["ref"], got[:FIR_N])
        log(f"{label} in graph mode: SNR vs float64 golden {snr:.2f} dB on "
            f"{FIR_N} samples (gate {FIR_GATE_DB})")
        require(snr >= FIR_GATE_DB, f"{label}: below the gate")
    return launches


def phase_params() -> None:
    """31. Parameter changes under graph mode: a new tone (dphase, copied
    into its tensor in place) between two runs of one runner, in the fused
    receiver's sig_source and in the live receiver, keeps the captured
    chunk and equals a fresh runner's output; a new center_freq (a fence)
    captures anew and equals a fresh runner's."""
    from newsched_tpu_torch.runtime import runner as rt

    nb = rt.GRAPH_CHUNK + 1
    tone2, center2 = 187_500.0, 210e3
    for kind in ("fused", "live"):
        fg, blks = wb_graph(kind, nb)
        r = fg.run(device="cuda")
        chunk, before = r._chunk, blks["sink"].data().copy()
        blks["source"].set_frequency(tone2)
        r.run_to_completion()
        fg2, blks2 = wb_graph(kind, nb, tone=tone2)
        fg2.run(device="cuda")
        require(r._chunk is chunk and chunk.graph is not None,
                f"{kind}: a dphase change captured anew")
        require(np.array_equal(blks["sink"].data(), blks2["sink"].data())
                and not np.array_equal(before, blks["sink"].data()),
                f"{kind}: the new dphase did not take effect in graph mode")
        log(f"graph mode, wbfm {kind}: a dphase change between runs kept "
            f"the chunk and equals a fresh runner's output")
    fg, blks = wb_graph("fused", nb)
    r = fg.run(device="cuda")
    chunk = r._chunk
    blks["fused"].set_param("center_freq", center2)
    r.run_to_completion()
    fg2, blks2 = wb_graph("fused", nb, center=center2)
    fg2.run(device="cuda")
    require(r._chunk is not chunk and r._chunk.graph is not None,
            "center_freq: no new capture")
    require(np.array_equal(blks["sink"].data(), blks2["sink"].data()),
            "center_freq: graph mode differs from a fresh runner")
    log("graph mode, wbfm fused: a center_freq change captured anew and "
        "equals a fresh runner's output")


def phase_counters(torch, fm_chain, noise) -> None:
    """32. K4 and K5 started from the sources' counter on the card at group
    2^32-2 and at a negative group: K4 bit-equal to its plain version at
    the same base (mask_pre off and on, each with and without an
    amplitude, as rows and as the cf32 stream), K5 bit-equal to K4 * amp
    -> K3 and its carry (the generated rows) to its plain version's."""
    consts = chain_consts()
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    st = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    for base in ((1 << 32) - 2, -3):
        g = noise.group_tensor(base, "cuda")
        for mask in (False, True):
            k4_modes(torch, noise, g, mask)
        k5 = fm_chain.fm_chain_gen_step(g, amp, *st, consts, DECIM, DEMOD_GAIN,
                                        ROWS)
        k4k3 = composed(noise.gaussian_rows, fm_chain.fm_chain_step_planes)(
            g, amp, *st, consts, DECIM, DEMOD_GAIN, ROWS, draws=3)
        plain = fm_chain.fm_chain_gen_step_plain(base, amp, *st, consts, DECIM,
                                                 DEMOD_GAIN, ROWS)
        require(all(torch.equal(a, b) for a, b in zip(k5, k4k3)),
                f"K5 at group {base}: differs from K4 -> K3")
        require(torch.equal(k5[3], plain[3]),
                f"K5 at group {base}: its rows differ from the plain version's")
        nxt = noise.advance(g, ROWS // noise.GROUP_ROWS)
        require(int(nxt) == noise._i64(base + ROWS // noise.GROUP_ROWS),
                f"the counter's advance from {base} on the card")
        log(f"on-card counter at group {base}: K4 bit-equal to plain (mask_pre "
            f"off and on, with and without an amplitude, as rows and as the "
            f"cf32 stream), K5 bit-equal to K4 * amp -> K3, its rows to plain")


def phase_probes(torch, fm_chain) -> dict:
    """33. The probes against their plain versions: window_copy in every
    variant exactly, planes_unpack bit-equal to cplx_to_planes over two
    batches, the ablation's "full" bit-equal to K3 and every variant within
    K3_TOL of max(1, max|out|) of its plain version on the FM band."""
    from newsched_tpu_torch.blocks import vector_dsp
    from newsched_tpu_torch.probes import ablate, dma, prep, run

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(run.ROWS + run.H8, 128, device="cuda", generator=g)
    cases = [("dbuf", T, x, None, run.H8) for T in run.DMA_TILES]
    cases += [("single", T, x, None, run.H8) for T in run.DMA_TILES]
    xr, xi = (torch.randn(run.ROWS + run.H8, 64, device="cuda", generator=g)
              for _ in range(2))
    cases += [("split", T, xr, xi, run.H8) for T in (64, run.K3_TILE)]
    for W in dma.LANES["dbuf"]:
        cases.append(("dbuf", 16384 // W, torch.randn(
            run.NTOT // W, W, device="cuda", generator=g), None, 0))
    x5 = torch.randn(run.NTOT // 512, 512, device="cuda", generator=g)
    cases += [("direct", T, x5, None, 0) for T in (512, 32)]
    for variant, T, xx, xxi, H in cases:
        got = dma.window_copy(xx, T, H, variant=variant, xi=xxi)
        require(torch.equal(got, dma.window_copy_plain(xx, T, H, xxi)),
                f"window_copy {variant} tile {T} x {xx.shape[1]}: differs "
                f"from its plain version")
    log(f"window_copy: {len(cases)} variants and tiles exactly equal to the "
        f"plain strided slice, every tile's slot checked")
    xs = torch.from_numpy(fm_band(2 * BATCH, "cuda")).cuda()
    skew = torch.zeros(M - 1, dtype=torch.complex64, device="cuda")
    blk = vector_dsp.cplx_to_planes(M)
    bst = blk.init_state(BATCH, ROWS, "cuda")
    for b in range(2):
        xb = xs[b * BATCH:(b + 1) * BATCH]
        got, skew = prep.planes_unpack(xb, skew)
        bst, ref = blk.work(bst, {"in": xb}, {}, ROWS)
        require(torch.equal(got, ref["out"]) and torch.equal(skew, bst["skew"]),
                f"planes_unpack batch {b}: differs from cplx_to_planes")
    log("planes_unpack: two carried batches bit-equal to cplx_to_planes")
    n = ROWS - 13  # off the kernel's 16 rows a block
    for off in (0, 1):  # a stream on a 16-byte boundary, and 8 bytes off it
        xb = xs[:n * M + 1].clone()[off:off + n * M]  # a view: its offset stays
        require(xb.data_ptr() % 16 == 8 * off, "planes_unpack: the stream's "
                "offset is not the one meant")
        skew0 = xs[-(M - 1):].clone()
        ref, rskew = prep.planes_unpack_plain(xb, skew0)
        got, nskew = prep.planes_unpack(xb, skew0)
        require(torch.equal(got, ref) and torch.equal(nskew, rskew),
                f"planes_unpack at {n} rows, offset {8 * off} B: differs "
                f"from its plain version")
        xb.zero_()
        require(torch.equal(nskew, rskew),
                "planes_unpack: the next skew is not its own storage")
    log(f"planes_unpack at {n} rows, from a stream on a 16-byte boundary and "
        f"8 bytes off it: rows and next skew bit-equal to its plain version; "
        f"the skew kept when the batch is overwritten")
    consts = chain_consts()
    rows = band_rows(torch)[:ROWS]
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    st = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    k3 = fm_chain.fm_chain_step_planes(rows, *st, consts, DECIM, DEMOD_GAIN)
    full = ablate.fm_chain_ablate(rows, *st, consts, DECIM, DEMOD_GAIN)
    require(all(torch.equal(a, b) for a, b in zip(full, k3)),
            "ablation full: differs from K3")
    worst = 0.0
    for v in ablate.VARIANTS:
        got = ablate.fm_chain_ablate(rows, *st, consts, DECIM, DEMOD_GAIN, v)[0]
        ref = ablate.fm_chain_ablate_plain(rows, *st, consts, DECIM,
                                           DEMOD_GAIN, v)[0]
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        log(f"ablation {v}: max abs err vs plain {err:.3e} (max|out| "
            f"{scale:.3e}; tol {K3_TOL} x max(1, max|out|))")
        require(err <= K3_TOL * max(1.0, scale),
                f"ablation {v}: disagrees with its plain version")
        worst = max(worst, err)
    return {"window_copy": 0.0, "planes_unpack": 0.0, "ablate": worst}


def graph_cells(rows: np.ndarray) -> dict:
    """Every timed cell as (builder of its graph with a null sink, input
    samples a batch, mesh)."""
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh

    def ch(source, **kw):
        return lambda: flowgraph(source() if callable(source) else source,
                                 None, sink="null", **kw)[0]

    replay = lambda: general.vector_source(rows, repeat=True)
    cells = {"replay": (ch(replay), BATCH, None),
             "noise source": (ch(None), BATCH, None),
             "staged": (ch(None, fused=False), BATCH, None),
             "live": (ch("live"), BATCH, None)}
    for kind in ("staged", "fused", "folded", "live"):
        cells[f"wbfm {kind}"] = (lambda kind=kind: wb_graph(kind, None,
                                                            "null")[0],
                                 WB_BATCH, None)
    for kind in ("staged", "live"):
        cells[f"fir_chain {kind}"] = (lambda kind=kind: fir_graph(
            kind, FIR_N, sink="null")[0], FIR_BATCH, None)
    for n in MESHES:
        cells[f"live, {n} shards"] = (ch("live"), BATCH, make_mesh(n))
        cells[f"replay, {n} shards"] = (ch(replay), BATCH, make_mesh(n))
    return cells


GRAPH_K = (16, 64)     # the two points of chip_smoke's graph-mode fits
CHUNKS = (2, 4, 8, 16)  # chunk sizes measured for runner.GRAPH_CHUNK


def phase_graph_times(torch, rows: np.ndarray, card: str) -> dict:
    """34a. Each cell's graph-mode step by the bench's two-point fit, beside
    its loop-mode step and its profiled device time (the busy share in
    graph mode); the chunk sizes on a host-bound and a device-bound cell;
    a short run of the bench's timer on its headline path."""
    from newsched_tpu_torch import bench

    out = {}
    for label, (build, n_in, mesh) in graph_cells(rows).items():
        sps = bench.timed_two_point(
            bench.graph_run(build(), "cuda", mesh=mesh), f"graph mode {label}",
            n_in, n_best=3, k1=GRAPH_K[0], k2=GRAPH_K[1])
        ms = n_in / sps * 1e3
        loop_ms, dev_ms = LOOP.get(label, (None, None))
        busy = "not profiled" if dev_ms is None else f"{100 * dev_ms / ms:.0f}%"
        log(f"cell {label}: graph mode {ms:.4f} ms = {n_in / ms / 1e3:.1f} "
            f"Msamples/s; loop {loop_ms if loop_ms is None else round(loop_ms, 4)}"
            f" ms; device {dev_ms if dev_ms is None else round(dev_ms, 4)} ms "
            f"a step; busy in graph mode {busy} [{card}]")
        out[label] = ms
    cells = graph_cells(rows)
    for label in ("wbfm staged", "replay"):
        build, n_in, _ = cells[label]
        for C in CHUNKS:
            sps = bench.timed_two_point(
                bench.graph_run(build(), "cuda", chunk=C),
                f"chunk {C}, {label}", n_in, n_best=3, k1=GRAPH_K[0],
                k2=GRAPH_K[1])
            log(f"graph chunk {C} steps, {label}: {n_in / sps * 1e3:.4f} ms a "
                f"step [{card}]")
    taps, audio_taps = design()
    run_k, gate_audio, brows, B = bench.graph_paths(taps, audio_taps, BATCH,
                                                    "cuda")
    require(np.array_equal(brows, rows), "the bench's batch is not phase 6's")
    ref, bad = golden(None, "replay")  # phase 6's golden, its first batch
    ref, bad = ref[:N_AUD], bad[:N_AUD]
    snr = bench.snr_db(ref[~bad], gate_audio()[~bad])
    require(snr >= bench.GATE_DB, f"the bench's headline gate: {snr:.2f} dB")
    sps = bench.timed_two_point(run_k, "bench headline (K1 = 10, K2 = 40)", B,
                                k1=10, k2=40)
    log(f"bench timer, headline path: {sps / 1e6:.1f} Msamples/s at "
        f"{snr:.2f} dB [{card}]")
    return out


def phase_probe_times(torch, card: str) -> dict:
    """34b. The probes' measurements (the probes' main path, counted):
    GB/s of each window copy beside 3.35 TB/s, the prep pass, the
    ablation beside K3; and each probe kernel's plain and library times."""
    from newsched_tpu_torch.probes import ablate, dma, prep, run
    from newsched_tpu_torch.probes._timing import graph_ms as pgraph_ms

    counters = {"window_copy": dma.window_copy, "planes_unpack":
                prep.planes_unpack, "ablate": ablate.fm_chain_ablate}
    for f in counters.values():
        f.launches = 0
    recs = run.dma_sweep(5) + run.prep_times(5) + run.ablate_times(5)
    launches = {k: f.launches for k, f in counters.items()}
    for r in recs:
        log(f"probe {json.dumps(r)} [{card}]")
    require(all(n > 0 for n in launches.values()),
            f"a probe kernel was never launched: {launches}")
    by = {(r.get("case") or r.get("variant"), r.get("tile")): r for r in recs}
    x = torch.randn(run.ROWS + run.H8, 128, device="cuda")
    xc, skew, _, _, _, _, _ = run.chain_inputs()
    # the kernel's rows are skewed, row k = samples kM-(M-1) .. kM of the
    # stream, and start 8 bytes off a 16-byte boundary. The library call
    # (the probes' "cat_skewed_torch" and "cat_skewed_offset_torch", over
    # as many inputs and outputs as the kernel's) takes views of the same
    # rows in buffers built outside its timing, rows aligned and rows 8
    # bytes off as the kernel reads them; the faster is its time. Here
    # both once more on one input, and the earlier yardstick, rows
    # aligned to the batch
    rows_s = torch.cat([skew, xc])[:xc.numel()].view(-1, M)
    rows_c = xc.view(-1, M)
    cat_ms = {case: by[(case, None)]["us"] * 1e-3 for case in
              ("cat_skewed_torch", "cat_skewed_offset_torch")}
    t = {"window_copy": by[("dma_dbuf", run.K3_TILE)]["us"] * 1e-3,
         "window_copy plain": median_ms(
             lambda: dma.window_copy_plain(x, run.K3_TILE, run.H8)),
         "window_copy library": by[("torch_clone", None)]["us"] * 1e-3,
         "planes_unpack": by[("planes_unpack", None)]["us"] * 1e-3,
         "planes_unpack plain": median_ms(
             lambda: prep.planes_unpack_plain(xc, skew)),
         "planes_unpack library": min(cat_ms.values()),
         "planes_unpack library one input": pgraph_ms(
             lambda: torch.cat([rows_s.real, rows_s.imag], dim=1), 5),
         "planes_unpack library aligned": pgraph_ms(
             lambda: torch.cat([rows_c.real, rows_c.imag], dim=1), 5),
         "planes_unpack one input": pgraph_ms(
             lambda: prep.planes_unpack(xc, skew), 5),
         "ablate": by[("full", None)]["us"] * 1e-3}
    log(f"planes_unpack: {t['planes_unpack']:.4f} ms over 4 rotating inputs "
        f"and outputs, {t['planes_unpack one input']:.4f} ms on one; a "
        f"clone of the stream over 4 "
        f"{by[('clone_rotating_torch', None)]['us'] * 1e-3:.4f} ms; "
        f"torch.cat of the skewed rows' planes over 4: rows aligned "
        f"{cat_ms['cat_skewed_torch']:.4f} ms, 8 bytes off "
        f"{cat_ms['cat_skewed_offset_torch']:.4f} ms; aligned on one input "
        f"{t['planes_unpack library one input']:.4f} ms; of rows aligned to "
        f"the batch (one input) {t['planes_unpack library aligned']:.4f} ms "
        f"[{card}]")
    k3 = by[("K3", None)]["us"]
    for v in ablate.VARIANTS:
        log(f"ablation {v}: {by[(v, None)]['us']:.2f} us, K3 {k3:.2f} us, "
            f"{100 * by[(v, None)]['us'] / k3:.1f}% of K3 [{card}]")
    # what each stage costs: K3 less the variant without it; the window
    # load is the variant that only loads it
    split = {stage: k3 - by[(v, None)]["us"] for stage, v in (
        ("DFT", "no_dft"), ("fold", "no_fold"), ("demod", "no_demod"),
        ("atan2", "no_atan2"), ("audio FIR", "no_audio"))}
    split["window load"] = by[("dma_only", None)]["us"]
    log("K3 by stage (ablation): " + ", ".join(
        f"{stage} {us:.2f} us = {100 * us / k3:.1f}%" for stage, us in
        split.items()) + f" of K3's {k3:.2f} us [{card}]")
    return {"launches": launches, "t": t, "x_bytes": x.numel() * 4,
            "n_tiles": run.ROWS // run.K3_TILE, "stream_bytes": xc.numel() * 8}


# -- K3ag, tags, checkpoints, unbounded runs ----------------------------------

AG = (2, 4)                # the band counts K3ag is checked and timed at


def set_bands(fm_chain, ag: int) -> None:
    """Override the port's band picker, as a caller does: K3, K5 and K6
    read it at every call."""
    fm_chain._pick_audio_groups = lambda tile, decim, A: ag


def band_launches(fm_chain) -> int:
    return sum(getattr(f, f"ag{ag}_launches") for ag in AG
               for f in (fm_chain.fm_chain_step_planes,
                         fm_chain.fm_chain_gen_step,
                         fm_chain.fm_chain_gen_warm_step))


def phase_k3ag(torch, fm_chain, noise, replay_out, fused_out) -> dict:
    """35. K3, K5 and K6 at ag = 2 and 4 against ag = 1 (bit for bit) and
    their plain banded versions; the fused replay, live and 4-shard live
    flowgraphs at ag = 2 against ag = 1, K3ag's launches counted; times.
    Returns K3ag's launches on those flowgraphs, its worst error against
    the plain versions and the times."""
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh

    pick = fm_chain._pick_audio_groups
    consts, rows = chain_consts(), band_rows(torch)
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    st = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    g0 = noise.group_tensor(0, "cuda")
    _, bad = golden(None, "noise")  # phase 7's stream: K5's and K6's rows
    steps = {
        "K3": (lambda: k3_batches(torch, fm_chain, consts, rows,
                                  fm_chain.fm_chain_step_planes),
               lambda ag: k3_batches(torch, fm_chain, consts, rows,
                                     fm_chain.fm_chain_step_planes_plain,
                                     ag=ag, tile=128), None, K3_TOL),
        "K5": (lambda: list(fm_chain.fm_chain_gen_step(
                   g0, amp, *st, consts, DECIM, DEMOD_GAIN, ROWS)),
               lambda ag: list(fm_chain.fm_chain_gen_step_plain(
                   g0, amp, *st, consts, DECIM, DEMOD_GAIN, ROWS, ag=ag,
                   tile=128)), bad[:N_AUD], K5_TOL),
        "K6": (lambda: [fm_chain.fm_chain_gen_warm_step(
                   g0, amp, consts, DECIM, DEMOD_GAIN, K6_ROWS, warm=K6_WARM)],
               lambda ag: [fm_chain.fm_chain_gen_warm_step_plain(
                   g0, amp, consts, DECIM, DEMOD_GAIN, K6_ROWS, K6_WARM, ag=ag,
                   tile=128)], bad[:K6_ROWS // DECIM], K5_TOL)}
    worst, times = 0.0, {}
    try:
        for kid, (kernel, plain, mask, tol) in steps.items():
            set_bands(fm_chain, 1)
            one = kernel()
            for ag in AG:
                set_bands(fm_chain, ag)
                got, ref = kernel(), plain(ag)
                require(all(torch.equal(a, b) for a, b in zip(got, one)),
                        f"K3ag in {kid} at ag={ag}: differs from ag = 1")
                if mask is None:
                    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
                else:  # the audio off the branch cut, the state everywhere
                    err = float(np.abs(got[0].cpu().numpy()
                                       - ref[0].cpu().numpy())[~mask].max())
                    err = max([err] + [float((a - b).abs().max())
                                       for a, b in zip(got[1:3], ref[1:3])])
                log(f"K3ag in {kid} at ag={ag}: bit-equal to ag = 1; vs its "
                    f"plain banded version {err:.3e} (tol {tol})")
                require(err <= tol, f"K3ag in {kid} at ag={ag}: disagrees "
                        f"with its plain version")
                worst = max(worst, err)
        launches = 0
        for label, build, mesh, ref in (
                ("fused replay", lambda: flowgraph(
                    general.vector_source(planes_of(replay_rows()), repeat=True),
                    3), None, replay_out),
                ("live", lambda: flowgraph("live", 3), None, fused_out),
                ("live, 4 shards", lambda: flowgraph("live", 3), 4, fused_out)):
            out = {}
            for ag in (1, 2):
                set_bands(fm_chain, ag)
                fg, blks = build()
                zero_launches()
                fg.run(device="cuda",
                       mesh=None if mesh is None else make_mesh(mesh))
                n_ag = band_launches(fm_chain)
                require((n_ag > 0) == (ag > 1), f"{label} at ag={ag}: K3ag "
                        f"launched {n_ag} times")
                launches += n_ag
                out[ag] = blks["sink"].data()
            require(np.array_equal(out[2], out[1])
                    and np.array_equal(out[1], ref[:3 * N_AUD]),
                    f"{label} at ag = 2 differs from ag = 1")
            log(f"{label} flowgraph at ag = 2: bit-equal to ag = 1, K3ag "
                f"launched {n_ag} times on it")
        for ag in (1, *AG):
            set_bands(fm_chain, ag)
            times[f"K3 ag={ag}"] = graph_ms(lambda: fm_chain.fm_chain_step_planes(
                rows[:ROWS], *st, consts, DECIM, DEMOD_GAIN))
            times[f"K5 ag={ag}"] = graph_ms(steps["K5"][0])
            times[f"K6 ag={ag}"] = graph_ms(steps["K6"][0])
        times["plain"] = median_ms(lambda: fm_chain.fm_chain_step_planes_plain(
            rows[:ROWS], *st, consts, DECIM, DEMOD_GAIN, ag=2, tile=128),
            reps=PLAIN_REPS)
    finally:
        fm_chain._pick_audio_groups = pick
    return {"launches": launches, "err": worst, "t": times}


def replay_rows() -> np.ndarray:
    """Phase 6's replayed batch, as cf32 samples (2^21)."""
    rng = np.random.default_rng(0)
    return ((rng.standard_normal(BATCH) + 1j * rng.standard_normal(BATCH))
            * 0.5).astype(np.complex64)


def planes_of(x: np.ndarray) -> np.ndarray:
    from newsched_tpu_torch.testing import planes_rows

    return planes_rows(x, M)


def run_chunked(fg, chunk_steps: int, **kw):
    """fg through the runner's graph mode in chunks of ``chunk_steps`` (one
    capture, replayed), as fg.run() runs it in chunks of GRAPH_CHUNK."""
    from newsched_tpu_torch.runtime.runner import Runner

    fg.validate()
    r = Runner(fg, device="cuda", batch_size=fg.batch_size, **kw)
    for b in r.cfg.order:
        b._runtime = r
    try:
        r._run_graph(r.cfg.n_batches, chunk_steps)
    finally:
        for b in r.cfg.order:
            b._runtime = None
    require(r._chunk is not None and r._chunk.graph is not None,
            "no chunk was captured")
    return r


def phase_tags() -> None:
    """36. The fused flowgraph over a replayed cf32 batch with tags, 3
    batches in chunks of 2 (a capture, its replay and a stepped batch):
    tag offsets exact at full width, payloads intact, audio bit-equal to
    the untagged graph's; a tag capacity limit of 1 drops one tag of two in
    a batch and counts it."""
    from newsched_tpu_torch.blocks import general

    x = replay_rows()
    mid = 3 * BATCH // 2  # 3 * 2^20, in the second batch
    out = {}
    for key, tags, limit in (("untagged", None, None),
                             ("tagged", [(0, "start"), (mid, "mid", 7.5)], None),
                             ("limit 1", [(0, "start"), (1, "second"),
                                          (mid, "mid", 7.5)], 1)):
        fg, blks = flowgraph(general.vector_source(x, repeat=True, tags=tags), 3)
        r = run_chunked(fg, 2, tag_capacity_limit=limit)
        out[key] = (blks["sink"].data(), blks["sink"].tags(), r.stats)
    want = [(0, "start", (0.0, 0.0)), (mid // (M * DECIM), "mid", (7.5, 0.0))]
    for key in ("tagged", "limit 1"):
        got = [(t.offset, t.key, t.value) for t in out[key][1]]
        require(got == want, f"tags ({key}): {got}, want {want}")
        require(np.array_equal(out[key][0], out["untagged"][0]),
                f"tags ({key}): the audio differs from the untagged graph's")
    drops = out["limit 1"][2].get("tag_drops")
    require(drops == 1, f"tag_capacity_limit=1: {drops} drops counted, want 1")
    log(f"tags through the fused flowgraph, 3 batches in a captured chunk: "
        f"{want} (input offsets 0 and {mid} / {M * DECIM}); audio bit-equal "
        f"to the untagged graph's; tag_capacity_limit=1: 1 drop counted")


def phase_checkpoints() -> None:
    """37. The live channelizer (K5) and the live receiver (K12): 2N
    batches straight against N, a checkpoint and N resumed, bit for bit."""
    import os
    import tempfile

    n = 2
    for label, build in (("live channelizer", lambda nb: flowgraph("live", nb)),
                         ("live receiver", lambda nb: wb_graph("live", nb))):
        fg, blks = build(2 * n)
        fg.run(device="cuda")
        straight = blks["sink"].data()
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
        os.makedirs(root, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=root) as d:
            fg1, b1 = build(n)
            fg1.run(device="cuda", checkpoint_path=d, checkpoint_every=n)
            fg2, b2 = build(2 * n)
            r = fg2.run(device="cuda", resume_from=d)
        got = np.concatenate([b1["sink"].data(), b2["sink"].data()])
        require(r.stats["batches"] == n and np.array_equal(got, straight),
                f"{label}: checkpoint and resume differ from the straight run")
        log(f"checkpoint, {label}: {n} batches, a checkpoint, {n} resumed "
            f"bit-equal to {2 * n} straight")


def _await(cond, what: str, limit_s: float = 60.0) -> None:
    t0 = time.monotonic()
    while not cond():
        require(time.monotonic() - t0 < limit_s, f"timed out waiting for {what}")
        time.sleep(0.002)


def _stop(fg, r) -> None:
    """stop(), then the runner's thread joined (60 s at most) and wait()."""
    fg.stop()
    th = r._thread
    th.join(60.0)
    require(not th.is_alive(), "the runner thread did not stop")
    fg.wait()


def phase_unbounded(fm_chain) -> dict:
    """38. Unbounded runs under start()/stop(): the live channelizer into a
    null_sink and into a ring of 12288 audio rows, each timed (phase 39)
    and then checked; a fence from this thread during an unbounded config
    #1 fused run."""
    from newsched_tpu_torch.runtime.runner import GRAPH_CHUNK as C

    fg, blks = flowgraph("live", None, sink="null")
    zero_launches()
    r = fg.start(device="cuda")
    _await(lambda: r.stats["batches"] >= 3 * C, "three chunks")
    b1, t1 = r.stats["batches"], time.monotonic()
    time.sleep(1.0)
    b2, t2 = r.stats["batches"], time.monotonic()
    _stop(fg, r)
    nb, k5 = r.stats["batches"], fm_chain.fm_chain_gen_step.launches
    rate = (b2 - b1) * BATCH / (t2 - t1) / 1e6
    require(nb % C == 0 and nb >= 3 * C, f"unbounded live: {nb} batches")
    require(k5 == nb and r._chunk.graph is not None,
            f"unbounded live: K5 launched {k5} times in {nb} batches")
    require(blks["sink"].checksum is not None
            and np.isfinite(blks["sink"].checksum), "unbounded live: checksum")
    log(f"unbounded live channelizer: {nb} batches in chunks of {C} (K5 "
        f"launched {k5} times, through replays), stopped within a chunk")
    cap = 3 * N_AUD
    fg, blks = flowgraph("live", None)  # timed: its audio copied a chunk
    blks["sink"].collect_capacity = cap
    r = fg.start(device="cuda")
    _await(lambda: r.stats["batches"] >= 3 * C, "three chunks")
    b1, t1 = r.stats["batches"], time.monotonic()
    time.sleep(0.5)
    b2, t2 = r.stats["batches"], time.monotonic()
    _stop(fg, r)
    ring_rate = (b2 - b1) * BATCH / (t2 - t1) / 1e6
    fg, blks = flowgraph("live", None)
    blks["sink"].collect_capacity = cap
    r = fg.start(device="cuda")
    _await(lambda: r.stats["batches"] >= 3 * C, "three chunks")
    _stop(fg, r)
    nb, got = r.stats["batches"], blks["sink"].data()
    fg2, blks2 = flowgraph("live", nb)
    fg2.run(device="cuda")
    ref = blks2["sink"].data()
    require(nb % C == 0 and len(got) == cap <= len(ref)
            and np.array_equal(got, ref[-cap:]),
            f"unbounded ring: {len(got)} rows retained of {nb} batches, or "
            f"not the last {cap} rows of a bounded run")
    log(f"unbounded ring vector_sink(capacity={cap}): {nb} batches, "
        f"{len(got)} rows retained (at most {r.stats['retained_items']} held), "
        f"bit-equal to the last {cap} rows of a bounded run of {nb} batches")
    old, new, span = WB_FC, 210e3, 4096  # the ring holds 4096 batches
    fg, blks = wb_graph("fused", None, center=old)
    blks["sink"].collect_capacity = span * WB_NAUD * 64
    r = fg.start(device="cuda")
    _await(lambda: r.stats["batches"] >= C, "a chunk")
    blks["fused"].set_param("center_freq", new)
    b0 = r.stats["batches"]
    _await(lambda: r.stats["batches"] >= b0 + 2 * C, "two more chunks")
    _stop(fg, r)
    nb = r.stats["batches"]
    require(nb <= span, f"fence run: {nb} batches, more than the ring holds")
    got = blks["sink"].data().reshape(nb, -1)
    refs = {}
    for center in (old, new):
        rfg, rblks = wb_graph("fused", nb, center=center)
        rfg.run(device="cuda")
        refs[center] = rblks["sink"].data().reshape(nb, -1)
    at_old = [np.array_equal(got[i], refs[old][i]) for i in range(nb)]
    require(False in at_old, "fence: the new center_freq never took effect")
    k = at_old.index(False)
    require(k % C == 0 and all(at_old[:k])
            and np.array_equal(got[k:], refs[new][k:]),
            f"fence: landed at batch {k} (chunks of {C}), or the output after "
            f"it is not the new value's")
    log(f"fence from the caller's thread during an unbounded wbfm fused run "
        f"of {nb} batches: landed at batch {k}, a chunk boundary; before it "
        f"bit-equal to the old center_freq's run, after it to the new one's")
    return {"rate": rate, "ring rate": ring_rate}


def phase_pacing(card: str) -> float:
    """39b. The throttle at 10 Msamples/s: a null_source -> throttle ->
    head of 10 batches of 2^20 samples; the run's wall time against the
    10 batches' time at that rate."""
    from newsched_tpu_torch import Flowgraph
    from newsched_tpu_torch.blocks import general

    rate, n = 10e6, 10 << 20
    fg = Flowgraph(batch_size=1 << 20)
    thr, hd = general.throttle(rate), general.head(n)
    fg.connect(general.null_source(), 0, thr, 0)
    fg.connect(thr, 0, hd, 0)
    fg.connect(hd, 0, general.null_sink(), 0)
    t0 = time.monotonic()
    fg.run(device="cuda")
    dt = time.monotonic() - t0
    err = (dt - n / rate) / (n / rate)
    log(f"throttle at {rate / 1e6:.0f} Msamples/s, {n} samples: {dt:.4f} s "
        f"against {n / rate:.4f} s, pacing error {100 * err:+.2f}% [{card}]")
    require(abs(err) < 0.2, "throttle: pacing error above 20%")
    return err


# -- K9 past the FFT's taps; the chains and K1 past 64 channels --------------

K9_WIDE_TAPS = (514, 1024, 6001)  # the partitioned instance's (past
# FFT_MAX_TAPS = 513): 2, 2 and 12 partitions; 6001 the direct form's old limit
K9_LIVE_TAPS = 1024        # the live graph past the FFT instance's taps
# (tile, seg_group) of the partitioned instance's blocks, the default first
K9P_GEOMS = ((512, 16), (512, 8), (1024, 8), (2048, 8), (1024, 16), (512, 32))
K9_WIDE_N = 2 * FIR_BATCH   # the 1024-tap live graph: two batches, graph mode
WIDE_M = (128, 256, 320, 384, 448, 512, 1024)  # channels past the
# flagship's the chains and K1 take (M = 64 P), checked and run in graphs
INSTANCE_M = (192, 576, 640, 704, 768, 832, 896, 960)  # every other P =
# 2 .. 16 (phase 41's instance check): each factor of the radix-P passes
WIDE_ROWS = 16384           # planes rows a batch at those widths
K1_WIDE_M = (320, 384, 448, 512, 960, 1024)  # K1 past 256 channels, timed
STREAM_M = (320, 384, 448, 512, 1024)  # the chains' widths past 256, timed
# (phase 43): chain_tile_stream to 448, chain_tile_wide past it
STAGED_M = (320, 512, 1024)  # phase 49's staged graphs
ROUTE_M = tuple(range(512, 1025, 64))  # K1 checked against K7 + cuFFT's
ROUTE_TIMED = (512, 576, 704, 896, 1024)  # combine, and timed beside it


def wide_taps(torch, ntaps: int):
    """Config #0's lowpass at ``ntaps``, and K9's constants for it."""
    from newsched_tpu_torch.ops import firdes
    from newsched_tpu_torch.ops.cuda import fir_source

    taps = firdes.low_pass(1.0, FIR_FS, 0.2 * FIR_FS, 0.05 * FIR_FS,
                           ntaps=ntaps)
    return taps, fir_source.fir_tone_consts(taps, "cuda")


def phase_k9_part(torch, fir_source) -> dict:
    """40. K9's partitioned instance at 514, 1024 and 6001 taps: within
    K9_TOL of its plain version (two batches from stream start, D = 1 and
    4), counted on ``partitioned_launches`` (the FFT instance never),
    bit-identical at tile 256 and for four batches of 2^20 against two of
    2^21 (splits on multiples of its L = 512 outputs); past its stated
    limit a ValueError names it. Then the live fir_chain at 1024 taps in
    graph mode against its float64 golden (the fixed-point tone through
    the FIR, by FFT convolution), its launches counted."""
    from scipy.signal import fftconvolve

    from newsched_tpu_torch import models
    from newsched_tpu_torch.ops import nco
    from newsched_tpu_torch.testing import fxpt_tone, snr_db

    dp = nco.freq_to_dphase(FIR_FREQ, FIR_FS)
    worst = 0.0
    for nt in K9_WIDE_TAPS:
        taps, tc = wide_taps(torch, nt)
        for D in (1, 4):
            outs = {}
            for kind, step in (("kernel", fir_source.fir_tone_step),
                               ("plain", fir_source.fir_tone_step_plain)):
                ph, first, parts = 0, True, []
                for _ in range(2):
                    arg = tc if kind == "kernel" else tc.taps
                    parts.append(step(ph, dp, 0.8, first, arg, D, FIR_R))
                    ph, first = nco.nco_advance(ph, dp, FIR_BATCH), False
                outs[kind] = torch.cat(parts)
            err = float((outs["kernel"] - outs["plain"]).abs().max())
            scale = float(outs["plain"].abs().max())
            log(f"K9 partitioned instance, {nt} taps "
                f"({fir_source.part_count(nt)} partitions), D={D}: 2 batches "
                f"from stream start, max abs err vs plain {err:.3e} = "
                f"{err / scale:.3e} of max|out| (tol {K9_TOL})")
            require(err <= K9_TOL * scale, f"K9 at {nt} taps, D={D}: kernel "
                    f"disagrees with its plain version")
            worst = max(worst, err)
        fft0, part0 = fir_source.fir_tone_step.launches, \
            fir_source.fir_tone_step.partitioned_launches
        base = torch.cat([fir_source.fir_tone_step(0, dp, 0.8, True, tc, 1,
                                                   FIR_R),
                          fir_source.fir_tone_step(nco.nco_advance(0, dp,
                                                                   FIR_BATCH),
                                                   dp, 0.8, False, tc, 1,
                                                   FIR_R)])
        require(fir_source.fir_tone_step.launches == fft0
                and fir_source.fir_tone_step.partitioned_launches == part0 + 2,
                f"K9 at {nt} taps: not the partitioned instance")
        tiled = torch.cat([fir_source.fir_tone_step(
            0, dp, 0.8, True, tc, 1, FIR_R, tile=256),
            fir_source.fir_tone_step(nco.nco_advance(0, dp, FIR_BATCH), dp,
                                     0.8, False, tc, 1, FIR_R, tile=256)])
        ph, first, half = 0, True, []
        for _ in range(4):
            half.append(fir_source.fir_tone_step(ph, dp, 0.8, first, tc, 1,
                                                 FIR_R // 2))
            ph, first = nco.nco_advance(ph, dp, FIR_BATCH // 2), False
        require(torch.equal(base, tiled),
                f"K9 partitioned at {nt} taps: tile 256 differs from the "
                f"default")
        full = torch.cat([fir_source.unfold_complex(base[:FIR_R]),
                          fir_source.unfold_complex(base[FIR_R:])])
        split = torch.cat([fir_source.unfold_complex(h) for h in half])
        require(torch.equal(full, split), f"K9 partitioned at {nt} taps: "
                f"batches of 2^20 differ from batches of 2^21")
        log(f"K9 partitioned instance, {nt} taps: tile 256 and the default, "
            f"batches of 2^20 and 2^21 give bit-identical output")
    limit = fir_source.PART_MAX_TAPS
    try:
        fir_source.fir_tone_step(0, dp, 0.8, True,
                                 wide_taps(torch, limit + 1)[1], 1, FIR_R)
        require(False, f"K9 took {limit + 1} taps, past its stated limit")
    except ValueError as e:
        require(f"at most {limit} taps" in str(e), f"K9's refusal: {e}")
        log(f"K9 at {limit + 1} taps raises: {e}")
    # the live graph at 1024 taps, two batches: graph mode
    nt = K9_LIVE_TAPS
    fg, blks = models.fir_chain(n_samples=K9_WIDE_N, fs=FIR_FS, ntaps=nt,
                                frequency=FIR_FREQ, batch_size=FIR_BATCH,
                                sink="vector", source="live")
    fir_source.fir_tone_step.launches = 0
    fir_source.fir_tone_step.partitioned_launches = 0
    fg.run(device="cuda")
    launches = fir_source.fir_tone_step.partitioned_launches
    got = blks["sink"].data()
    x = fxpt_tone(K9_WIDE_N, dp)
    ref = fftconvolve(x, np.asarray(blks["taps"], np.float64))[:K9_WIDE_N]
    snr = snr_db(ref, got)
    log(f"fir_chain live at {nt} taps (graph mode, {K9_WIDE_N} samples): SNR "
        f"vs float64 golden {snr:.2f} dB (gate {FIR_GATE_DB}); partitioned "
        f"instance launched {launches} times, the FFT instance "
        f"{fir_source.fir_tone_step.launches}")
    require(got.shape == (K9_WIDE_N,) and snr >= FIR_GATE_DB,
            f"fir_chain live at {nt} taps below its gate")
    require(launches > 0 and fir_source.fir_tone_step.launches == 0,
            f"fir_chain live at {nt} taps did not run the partitioned "
            f"instance")
    return {"err": worst, "launches": launches, "snr": snr}


def wide_design(m: int):
    from newsched_tpu_torch.ops import firdes

    taps = firdes.prototype_channelizer_taps(m, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.4 / DECIM, 0.1 / DECIM, ntaps=A)
    return taps, audio_taps


def wide_consts(m: int):
    from newsched_tpu_torch.blocks import vector_dsp

    taps, audio_taps = wide_design(m)
    return vector_dsp.fm_channelizer_fused_planes(
        m, taps, audio_taps, audio_decim=DECIM).consts("cuda")


def wide_golden(rows: np.ndarray, m: int, key: str):
    from newsched_tpu_torch.testing import rows_reference

    if key not in _GOLDEN:
        taps, audio_taps = wide_design(m)
        _GOLDEN[key] = rows_reference(rows, taps, audio_taps, nchans=m,
                                      audio_decim=DECIM,
                                      demod_gain=DEMOD_GAIN, return_risk=True)
    return _GOLDEN[key]


def wide_noise(torch, noise, m: int, n_rows: int) -> np.ndarray:
    amp = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    return (noise.gaussian_rows_plain(0, n_rows=n_rows, width=2 * m, seed=0,
                                      device="cuda") * amp).cpu().numpy()


def phase_wide_kernels(torch, fm_chain, noise) -> dict:
    """41. K3, K5 and K6 at WIDE_M (16 taps an arm, a 65-tap
    audio FIR decimating by 8, batches of 16384 rows): K3 on two carried
    batches of an M-station FM band within K3_TOL of its plain version,
    bit-identical at tile 64 and at its default; K5 from stream start
    bit-equal to K4 * amp -> K3 and within K5_TOL of its plain version off
    the golden's branch-cut mask; K6 at a quarter batch from shard 3
    bit-equal to K5's stream there and within K5_TOL of its plain
    version, and over the batch's 4 shards in one launch bit-equal to K5.
    Returns the worst errors."""
    from newsched_tpu_torch.testing import planes_rows

    n = WIDE_ROWS
    worst = {"K3": 0.0, "K5": 0.0, "K6": 0.0}
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    for m in WIDE_M:
        consts = wide_consts(m)
        W = 2 * m
        rows = torch.from_numpy(planes_rows(fm_band(2 * n * m, "cuda", m),
                                            m)).cuda()

        def k3(step, **kw):
            halo, prev = torch.zeros(16, W, **z), torch.zeros(1, W, **z)
            tail, outs = torch.zeros(A - 1, W, **z), []
            for b in range(2):
                vb = rows[b * n:(b + 1) * n]
                aud, prev, tail = step(vb, halo, prev, tail, consts, DECIM,
                                       DEMOD_GAIN, **kw)
                outs += [aud, prev, tail]
                halo = vb[-16:].contiguous()
            return outs

        got = k3(fm_chain.fm_chain_step_planes)
        err = max(float((g - r).abs().max()) for g, r in
                  zip(got, k3(fm_chain.fm_chain_step_planes_plain)))
        require(err <= K3_TOL, f"K3 at M={m}: {err:.3e} from its plain version")
        require(all(torch.equal(a, b) for a, b in
                    zip(got, k3(fm_chain.fm_chain_step_planes, tile=64))),
                f"K3 at M={m}: tile 64 differs from the default tile")
        worst["K3"] = max(worst["K3"], err)
        zero = (torch.zeros(16, W, **z), torch.zeros(1, W, **z),
                torch.zeros(A - 1, W, **z))
        g0 = noise.group_tensor(0, "cuda")
        k5 = fm_chain.fm_chain_gen_step(g0, amp, *zero, consts, DECIM,
                                        DEMOD_GAIN, n)
        nrows = noise.gaussian_rows(g0, n_rows=n, width=W, seed=0,
                                    device="cuda", amp=amp)
        k4k3 = fm_chain.fm_chain_step_planes(nrows, *zero, consts, DECIM,
                                             DEMOD_GAIN)
        require(all(torch.equal(a, b) for a, b in zip(k5[:3], k4k3))
                and torch.equal(k5[3], nrows[-16:]),
                f"K5 at M={m}: differs from K4 * amp -> K3")
        _, bad = wide_golden(wide_noise(torch, noise, m, n), m,
                             f"noise M={m}")
        p5 = fm_chain.fm_chain_gen_step_plain(g0, amp, *zero, consts, DECIM,
                                              DEMOD_GAIN, n)
        e5 = float(np.abs(k5[0].cpu().numpy() - p5[0].cpu().numpy())[~bad].max())
        require(e5 <= K5_TOL, f"K5 at M={m}: {e5:.3e} from its plain version")
        q = n // 4
        k6 = fm_chain.fm_chain_gen_warm_step(g0, amp, consts, DECIM,
                                             DEMOD_GAIN, q, warm=K6_WARM,
                                             goff=3 * q // 64)
        sl = slice(3 * q // DECIM, n // DECIM)
        require(torch.equal(k6, k5[0][sl]),
                f"K6 at M={m}: differs from K5's stream at shard 3")
        p6 = fm_chain.fm_chain_gen_warm_step_plain(3 * q // 64, amp, consts,
                                                   DECIM, DEMOD_GAIN, q,
                                                   K6_WARM)
        e6 = float(np.abs(k6.cpu().numpy() - p6.cpu().numpy())[~bad[sl]].max())
        require(e6 <= K5_TOL, f"K6 at M={m}: {e6:.3e} from its plain version")
        require(torch.equal(fm_chain.fm_chain_gen_warm_step(
            g0, amp, consts, DECIM, DEMOD_GAIN, q, warm=K6_WARM, nd=4), k5[0]),
                f"K6 at M={m} over 4 shards in one launch: differs from K5")
        worst["K5"], worst["K6"] = max(worst["K5"], e5), max(worst["K6"], e6)
        log(f"M={m} ({W} lanes, {n} rows): K3 {err:.3e} from plain (tol "
            f"{K3_TOL}), tiles 64 and {fm_chain._fit_tile(128, W, A, L, DECIM, DECIM)}"
            f" bit-identical; K5 bit-equal to K4 * amp -> K3, {e5:.3e} from "
            f"plain off the branch cut (tol {K5_TOL}); K6 bit-equal to K5's "
            f"stream at shard 3 and over 4 shards in one launch, {e6:.3e} "
            f"from plain")
    return worst


def phase_chain_instances(torch, fm_chain, noise) -> float:
    """41, the other widths: K3, K5 and K6 at INSTANCE_M (M = 192 and 576
    .. 960, with WIDE_M every P = 2 .. 16 and so every factor of the
    radix-P step's two passes), batches of 4096 rows: K3 on two carried
    batches of an M-station FM band within K3_TOL of its plain version and
    bit-identical at tile 64; K5 from stream start bit-equal to K4 * amp
    -> K3; K6 over the batch's 4 shards in one launch bit-equal to K5.
    Returns K3's worst error."""
    from newsched_tpu_torch.testing import planes_rows

    n, worst = WIDE_ROWS // 4, 0.0
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    g0 = noise.group_tensor(0, "cuda")
    for m in INSTANCE_M:
        consts, W = wide_consts(m), 2 * m
        rows = torch.from_numpy(planes_rows(fm_band(2 * n * m, "cuda", m),
                                            m)).cuda()

        def k3(step, **kw):
            halo, prev = torch.zeros(16, W, **z), torch.zeros(1, W, **z)
            tail, outs = torch.zeros(A - 1, W, **z), []
            for b in range(2):
                vb = rows[b * n:(b + 1) * n]
                aud, prev, tail = step(vb, halo, prev, tail, consts, DECIM,
                                       DEMOD_GAIN, **kw)
                outs += [aud, prev, tail]
                halo = vb[-16:].contiguous()
            return outs

        got = k3(fm_chain.fm_chain_step_planes)
        err = max(float((g - r).abs().max()) for g, r in
                  zip(got, k3(fm_chain.fm_chain_step_planes_plain)))
        tiles = all(torch.equal(a, b) for a, b in
                    zip(got, k3(fm_chain.fm_chain_step_planes, tile=64)))
        zero = (torch.zeros(16, W, **z), torch.zeros(1, W, **z),
                torch.zeros(A - 1, W, **z))
        k5 = fm_chain.fm_chain_gen_step(g0, amp, *zero, consts, DECIM,
                                        DEMOD_GAIN, n)
        nrows = noise.gaussian_rows(g0, n_rows=n, width=W, seed=0,
                                    device="cuda", amp=amp)
        k4k3 = fm_chain.fm_chain_step_planes(nrows, *zero, consts, DECIM,
                                             DEMOD_GAIN)
        k5_ok = all(torch.equal(a, b) for a, b in zip(k5[:3], k4k3))
        k6_ok = torch.equal(fm_chain.fm_chain_gen_warm_step(
            g0, amp, consts, DECIM, DEMOD_GAIN, n // 4, warm=K6_WARM, nd=4),
            k5[0])
        log(f"M={m} (P = {m // 64}, {n} rows): K3 {err:.3e} from plain (tol "
            f"{K3_TOL}), tile 64 bit-identical: {tiles}; K5 bit-equal to K4 "
            f"* amp -> K3: {k5_ok}; K6 over 4 shards in one launch bit-equal "
            f"to K5: {k6_ok}")
        require(err <= K3_TOL and tiles and k5_ok and k6_ok,
                f"chains at M={m}: K3 {err:.3e} from plain, tiles {tiles}, "
                f"K5 {k5_ok}, K6 {k6_ok}")
        worst = max(worst, err)
    return worst


def wide_graph(m: int, source, n_batches: int | None, batch: int, **kw):
    from newsched_tpu_torch import models

    taps, audio_taps = wide_design(m)
    return models.fm_channelizer(
        nchans=m, taps_per_arm=L, audio_decim=DECIM, fused=kw.pop("fused", True),
        source=source, batch_size=batch, sink=kw.pop("sink", "vector"),
        n_samples=None if n_batches is None else n_batches * batch // m // DECIM,
        deviation_frac=1.0 / (2 * np.pi * DEMOD_GAIN), audio_taps=audio_taps,
        **kw)


def phase_wide_graphs(torch, fm_chain, noise, channelizer) -> dict:
    """42. The fused (a replayed M-station FM band) and live
    fm_channelizer flowgraphs at WIDE_M, two batches each in graph
    mode: >= 95 dB against the float64 golden off its branch-cut mask, K3
    and K5 launched on them; the live graph on 4 shards, bit-equal to the
    unsharded one, K6 launched once a batch. At M = 128 also: both at half
    the batch, bit-equal; the staged graph (K4 -> K1 -> torch ops) >= 60
    dB with K1 launched. Returns each width's launch counts."""
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh
    from newsched_tpu_torch.testing import planes_rows, snr_db

    counts = {}
    for m in WIDE_M:
        batch = WIDE_ROWS * m
        rows = planes_rows(fm_band(batch, "cuda", m), m)
        out, counts[m] = {}, {}
        for kind, source in (("fused", general.vector_source(rows, repeat=True)),
                             ("live", "live")):
            fm_chain.fm_chain_step_planes.launches = 0
            fm_chain.fm_chain_gen_step.launches = 0
            fg, blks = wide_graph(m, source, 2, batch)
            fg.run(device="cuda")
            got = blks["sink"].data()
            stream = (np.concatenate([rows, rows]) if kind == "fused"
                      else wide_noise(torch, noise, m, 2 * WIDE_ROWS))
            ref, bad = wide_golden(stream, m, f"{kind} M={m}")
            require(got.shape == ref.shape and bool(np.isfinite(got).all()),
                    f"{kind} M={m}: shape {got.shape} or non-finite")
            snr = snr_db(ref[~bad], got[~bad])
            k = (fm_chain.fm_chain_step_planes.launches if kind == "fused"
                 else fm_chain.fm_chain_gen_step.launches)
            log(f"{kind} flowgraph at M={m} (graph mode, 2 batches of {batch}):"
                f" SNR vs float64 golden {snr:.2f} dB on {int((~bad).sum())} "
                f"samples (gate {SNR_GATE_DB}); "
                f"{'K3' if kind == 'fused' else 'K5'} launched {k} times")
            require(snr >= SNR_GATE_DB, f"{kind} M={m}: SNR {snr:.2f} dB")
            require(k > 0, f"{kind} M={m}: its kernel never launched")
            out[kind] = got
            counts[m][kind] = k
        fm_chain.fm_chain_gen_warm_step.launches = 0
        fm_chain.fm_chain_gen_step.launches = 0
        fg, blks = wide_graph(m, "live", 2, batch)
        fg.run(device="cuda", mesh=make_mesh(4))
        counts[m]["K6"] = fm_chain.fm_chain_gen_warm_step.launches
        require(np.array_equal(blks["sink"].data(), out["live"])
                and counts[m]["K6"] == 2
                and fm_chain.fm_chain_gen_step.launches == 0,
                f"live M={m} on 4 shards differs, or K6 not once a batch")
        log(f"live flowgraph at M={m} on 4 shards: bit-equal to the unsharded "
            f"one, K6 launched {counts[m]['K6']} times (once a batch)")
        if m != WIDE_M[0]:
            continue
        for kind, source in (("fused", general.vector_source(rows, repeat=True)),
                             ("live", "live")):
            fg, blks = wide_graph(m, source, 4, batch // 2)
            fg.run(device="cuda")
            require(np.array_equal(blks["sink"].data(), out[kind]),
                    f"{kind} M={m}: batches of {batch // 2} differ")
        channelizer.arm_fold_dft.launches = 0
        fg, blks = wide_graph(m, None, 2, batch, fused=False)
        fg.run(device="cuda")
        counts[m]["K1"] = channelizer.arm_fold_dft.launches
        r = noise.gaussian_rows_plain(0, n_rows=2 * batch // 64, width=128,
                                      seed=0, device="cuda")
        x = (torch.complex(r[:, :64].reshape(-1), r[:, 64:].reshape(-1))
             * 0.5).cpu().numpy()
        ref, bad = wide_golden(planes_rows(x, m), m, f"staged M={m}")
        snr = snr_db(ref[~bad], blks["sink"].data()[~bad])
        log(f"M={m}: fused and live at batches of {batch // 2} bit-equal to "
            f"batches of {batch}; staged {snr:.2f} dB (gate "
            f"{STAGED_GATE_DB}), K1 launched {counts[m]['K1']} times")
        require(snr >= STAGED_GATE_DB and counts[m]["K1"] > 0,
                f"staged M={m}: {snr:.2f} dB, or K1 never launched")
    return counts


def phase_wide_times(torch, fm_chain, channelizer, fir_source, noise,
                     card: str) -> dict:
    """43. Times at M = 128 (batches of 16384 rows of 256 lanes): K3, K5,
    K6 at a 4-shard batch's 4096 rows and K1, by CUDA-graph replay, beside
    their plain versions; at M = 320, 384 and 448 K3, K5 and K6 (over the 4
    shards of a batch in one launch) beside their plain versions and
    bounds; K9's partitioned instance at 1024 taps beside its plain
    version (3 calls: its 1024 taps are 1024 tensor passes), and at the
    largest tap count phase 40 checks."""
    from newsched_tpu_torch.ops import nco, pfb

    m, n = WIDE_M[0], WIDE_ROWS
    W = 2 * m
    consts = wide_consts(m)
    z = dict(dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(128)
    vb = torch.randn(n, W, device="cuda", generator=g) * 0.5
    st = (torch.zeros(16, W, **z), torch.zeros(1, W, **z),
          torch.zeros(A - 1, W, **z))
    amp = torch.tensor(0.5, **z)
    g0 = noise.group_tensor(0, "cuda")
    b6 = noise.group_tensor(3 * (n // 4) // 64, "cuda")
    taps, _ = wide_design(m)
    pc = pfb.pfb_consts(pfb.pfb_arm_taps(taps, m), "cuda")
    v = torch.randn(n + L - 1, W, device="cuda", generator=g) * 0.5
    k5_args = (g0, amp, *st, consts, DECIM, DEMOD_GAIN, n)
    t = alternate({
        "K3w plain": lambda: fm_chain.fm_chain_step_planes_plain(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K3w": lambda: fm_chain.fm_chain_step_planes(vb, *st, consts, DECIM,
                                                     DEMOD_GAIN),
        "K5w plain": lambda: fm_chain.fm_chain_gen_step_plain(*k5_args),
        "K5w": lambda: fm_chain.fm_chain_gen_step(*k5_args),
        "K6w plain": lambda: fm_chain.fm_chain_gen_warm_step_plain(
            b6, amp, consts, DECIM, DEMOD_GAIN, n // 4, K6_WARM),
        "K6w": lambda: fm_chain.fm_chain_gen_warm_step(
            b6, amp, consts, DECIM, DEMOD_GAIN, n // 4, warm=K6_WARM),
        "K1w plain": lambda: channelizer.arm_fold_dft_plain(v, pc.c2, pc.w2, n),
        "K1w": lambda: channelizer.arm_fold_dft(v, pc.c2, pc.w2, n,
                                                fft=pc.fft),
    }, PLAIN_REPS)
    ms = {k: min(x) for k, x in t.items()}
    for kid in ("K3w", "K5w", "K6w", "K1w"):
        log(f"{kid} at M={m}: kernel {t[kid]} ms, plain {t[kid + ' plain']} "
            f"ms [{card}]")
    # past 256 channels (chain_tile_stream): K6 as the sharded live graph
    # launches it, over the 4 shards of a batch in one grid
    for mw in STREAM_M:
        cw, Ww = wide_consts(mw), 2 * mw
        gw = torch.Generator(device="cuda").manual_seed(mw)
        vw = torch.randn(n, Ww, device="cuda", generator=gw) * 0.5
        sw = (torch.zeros(16, Ww, **z), torch.zeros(1, Ww, **z),
              torch.zeros(A - 1, Ww, **z))
        a5 = (g0, amp, *sw, cw, DECIM, DEMOD_GAIN, n)
        a6 = (g0, amp, cw, DECIM, DEMOD_GAIN, n // 4)
        tw = alternate({
            f"K3 M={mw} plain": lambda: fm_chain.fm_chain_step_planes_plain(
                vw, *sw, cw, DECIM, DEMOD_GAIN),
            f"K3 M={mw}": lambda: fm_chain.fm_chain_step_planes(
                vw, *sw, cw, DECIM, DEMOD_GAIN),
            f"K5 M={mw} plain": lambda: fm_chain.fm_chain_gen_step_plain(*a5),
            f"K5 M={mw}": lambda: fm_chain.fm_chain_gen_step(*a5),
            f"K6 M={mw} plain": lambda: fm_chain.fm_chain_gen_warm_step_plain(
                *a6, K6_WARM, nd=4),
            f"K6 M={mw}": lambda: fm_chain.fm_chain_gen_warm_step(
                *a6, warm=K6_WARM, nd=4),
        }, WIDE_PLAIN_REPS)
        ms.update({k: min(x) for k, x in tw.items()})
        tile = fm_chain._fit_tile(128, Ww, A, L, DECIM, DECIM)
        smem = fm_chain._chain_smem(tile, A, L, 1, DECIM, Ww)
        for kid in ("K3", "K5", "K6"):
            key = f"{kid} M={mw}"
            b_ms, by = chain_bounds(mw, n, n, nd=4)[kid]
            routine = "chain_tile_stream" if mw <= 448 else "chain_tile_wide"
            log(f"{key} ({n} x {Ww} rows{', 4 shards, one launch' if kid == 'K6' else ''}"
                f"; {routine}, tile {tile}, {smem} B shared): kernel "
                f"{tw[key]} ms, plain {tw[key + ' plain']} ms; bound "
                f"{b_ms:.4f} ms ({by}), {100 * b_ms / ms[key]:.1f}% of it "
                f"[{card}]")
    ph = nco.phase_tensor(7, "cuda")
    dp = nco.phase_tensor(nco.freq_to_dphase(FIR_FREQ, FIR_FS), "cuda")
    off = torch.zeros((), dtype=torch.bool, device="cuda")
    a8 = torch.tensor(0.8, **z)
    for nt, key in ((K9_LIVE_TAPS, "K9p"), (K9_WIDE_TAPS[-1], "K9p max")):
        _, tc = wide_taps(torch, nt)
        ms[key] = min(graph_ms(lambda: fir_source.fir_tone_step(
            ph, dp, a8, off, tc, 1, FIR_R)) for _ in range(2))
        ms[key + " plain"] = median_ms(lambda: fir_source.fir_tone_step_plain(
            ph, dp, a8, off, tc.taps, 1, FIR_R), reps=3, inner=1, warmup=1)
        log(f"K9 partitioned instance, {nt} taps ({FIR_R} x 128 rows): kernel "
            f"{ms[key]:.4f} ms, plain {ms[key + ' plain']:.4f} ms [{card}]")
    _, tc = wide_taps(torch, K9_LIVE_TAPS)
    for tile, gs in K9P_GEOMS:
        g = fir_source._part_geometry(FIR_R, 1, K9_LIVE_TAPS, tile, gs)
        k9p_ms = graph_ms(lambda: fir_source._launch(ph, dp, a8, off, tc, 1,
                                                     FIR_R, g))
        log(f"K9 partitioned, {K9_LIVE_TAPS} taps, tile {tile} seg_group {gs}: "
            f"{(FIR_R // tile) * (64 // gs)} blocks of {g.NQ * gs // 8} "
            f"rounds, {g.smem} B shared; {k9p_ms:.4f} ms [{card}]")
    return ms


# -- config #3: the overlap-save engines, its graph, the sharded FIR; config
# #1 de-emphasised; the block library's DSP half; K1 past 256 channels ------

FFT_BATCH = 1 << 21        # config #3's batch (bench/bm_micro.py bm_fft_filter)
FFT_SPLITS = (FFT_BATCH, FFT_BATCH - 8192, FFT_BATCH + 8192)  # uneven, carried
FFT_GATE_DB = 85.0         # the engines and config #3's graph vs float64
SHARD_GATE_DB = 120.0      # tests/test_mesh_graph.py's sharded-vs-unsharded gate
FFT_SIZES = (4096, 8192, 16384, 32768)  # the cuFFT engine's sweep
ENGINES = ("xla", "mxu")
AUTO_ENGINE = "xla"        # ops/fir.py fft_engine's pick on the card
DEEMPH_TAU = 75e-6
DENSE_ROWS = 16384         # planes rows a batch of phase 49's staged graphs


def golden64(x: np.ndarray, taps) -> np.ndarray:
    """The zero-state FIR of x (scipy.signal.lfilter's), in float64 by
    scipy's FFT convolution."""
    import scipy.signal as sig

    return sig.fftconvolve(x.astype(np.complex128),
                           np.asarray(taps, np.float64))[:len(x)]


def fft_stream(torch, fir, taps, x, splits, engine, fft_size=None):
    """fir_filter(method="fft") over consecutive batches of x on the card,
    the tail carried."""
    s, out, i0 = fir.fir_init_state(len(taps), "cuda"), [], 0
    for b in splits:
        s, y = fir.fir_filter(taps, s, x[i0:i0 + b], method="fft",
                              fft_method=engine, fft_size=fft_size)
        out.append(y)
        i0 += b
    return torch.cat(out).cpu().numpy()


def phase_engines(torch, card: str) -> dict:
    """44. The "fft" method's two engines at config #3's shape (1024 taps,
    three uneven batches around 2^21 carried across): >= 85 dB each against
    the float64 golden; a one-segment batch (16384 samples at fft_size
    16384) likewise; the engine "auto" picks; each engine's time by
    CUDA-graph replay over 4 rotating inputs and on one, beside the bound
    of the least bytes (2^21 cf32 in and out); the cuFFT engine at
    fft_size 4096-32768, recorded only."""
    from newsched_tpu_torch import bench
    from newsched_tpu_torch.ops import fir
    from newsched_tpu_torch.probes import run as probes
    from newsched_tpu_torch.testing import snr_db

    taps = bench.fft_filter_taps()
    gen = torch.Generator(device="cuda").manual_seed(44)
    x = torch.randn(sum(FFT_SPLITS), dtype=torch.complex64, device="cuda",
                    generator=gen)
    ref = golden64(x.cpu().numpy(), taps)
    ref1 = golden64(x[:16384].cpu().numpy(), taps)
    out = {"snr": {}, "ms": {}, "one": {}}
    for engine in ENGINES:
        snr = snr_db(ref, fft_stream(torch, fir, taps, x, FFT_SPLITS, engine))
        snr1 = snr_db(ref1, fft_stream(torch, fir, taps, x[:16384], (16384,),
                                       engine, 16384))
        log(f"fft engine {engine!r}: 1024 taps, batches {FFT_SPLITS}: SNR vs "
            f"float64 {snr:.2f} dB; one segment (16384 samples, fft_size "
            f"16384) {snr1:.2f} dB (gate {FFT_GATE_DB})")
        require(snr >= FFT_GATE_DB and snr1 >= FFT_GATE_DB,
                f"fft engine {engine}: {snr:.2f} / {snr1:.2f} dB")
        out["snr"][engine] = min(snr, snr1)
    ft = fir.fft_taps(taps, FFT_BATCH, True, "cuda")
    require(ft.engine == AUTO_ENGINE and ft.auto,
            f"fft_method='auto' picked {ft.engine!r}, want {AUTO_ENGINE!r}")
    log(f"fft_method='auto' on the card at {FFT_BATCH} samples, 1024 taps: "
        f"{ft.engine!r}, fft_size {ft.fft_size}")
    xs = [torch.randn(FFT_BATCH + len(taps) - 1, dtype=torch.complex64,
                      device="cuda", generator=gen) for _ in range(probes.ROT)]

    def timed(consts):
        call = lambda xx: fir.fft_filter_full(xx, taps, FFT_BATCH,
                                              consts=consts)
        return (graph_ms(probes.rotating(lambda i: (xs[i],), call)),
                graph_ms(lambda: call(xs[0])))

    b_ms = bound(2 * FFT_BATCH * 8, 0)[0]
    for _ in range(2):  # alternated: xla, mxu, xla, mxu
        for engine in ENGINES:
            c = fir.fft_taps(taps, FFT_BATCH, True, "cuda", engine)
            rot, one = timed(c)
            out["ms"].setdefault(engine, []).append(rot)
            out["one"].setdefault(engine, []).append(one)
    for engine in ENGINES:
        ms = min(out["ms"][engine])
        log(f"fft engine {engine!r} ({FFT_BATCH} cf32 samples, 1024 taps): "
            f"{out['ms'][engine]} ms over 4 rotating inputs, "
            f"{out['one'][engine]} ms on one; bound {b_ms:.4f} ms (bytes), "
            f"{100 * b_ms / ms:.1f}% of it [{card}]")
    for size in FFT_SIZES:
        rot, one = timed(fir.fft_taps(taps, FFT_BATCH, True, "cuda", "xla",
                                      size))
        log(f"fft engine 'xla' at fft_size {size}: {rot:.4f} ms over 4 "
            f"rotating inputs, {one:.4f} ms on one [{card}]")
    return out


def phase_config3(torch, card: str) -> dict:
    """45. Config #3's flowgraph (bench.fft_filter_graph: noise_source (K4)
    -> the 1024-tap fft_filter -> head -> sink, batches of 2^21) run by
    fg.run() in graph mode for 2C + 1 batches: bit-equal to the loop, K4
    launched, >= 85 dB against the float64 golden of the regenerated K4
    stream on its first 4 batches; its step by the bench's two-point fit
    beside its loop-mode step and profile; tags through fft_filter at decim
    2 over 3 batches in graph mode, offsets exact."""
    from newsched_tpu_torch import bench
    from newsched_tpu_torch.blocks import filter as filt, general
    from newsched_tpu_torch.runtime.graph import Flowgraph
    from newsched_tpu_torch.testing import snr_db

    B = FFT_BATCH
    got, counts = graph_vs_loop(
        lambda nb: bench.fft_filter_graph(nb * B, B, "vector"), "config #3",
        ("gaussian_rows.launches",))
    k4 = counts.get("gaussian_rows.launches", 0)
    n4 = 4 * B
    taps = bench.fft_filter_taps()
    snr = snr_db(bench.fft_filter_golden(n4, taps, "cuda"), got[:n4])
    log(f"config #3 graph mode: SNR vs float64 golden {snr:.2f} dB on the "
        f"first {n4} samples (gate {FFT_GATE_DB}); K4 launched {k4} times")
    require(snr >= FFT_GATE_DB and bool(np.isfinite(got).all()),
            f"config #3: {snr:.2f} dB or non-finite")
    sps = bench.timed_two_point(
        bench.graph_run(bench.fft_filter_graph(B * 1000, B)[0], "cuda"),
        "graph mode fft_filter", B, n_best=3, k1=GRAPH_K[0], k2=GRAPH_K[1])
    ms = B / sps * 1e3
    loop_ms = fg_step_rate(torch, bench.fft_filter_graph(B * 1000, B)[0],
                           "fft_filter", card, B)
    dev_ms = LOOP["fft_filter"][1]
    log(f"cell fft_filter: graph mode {ms:.4f} ms = {B / ms / 1e3:.1f} "
        f"Msamples/s; loop {loop_ms:.4f} ms; device {dev_ms:.4f} ms a step; "
        f"busy in graph mode {100 * dev_ms / ms:.0f}% [{card}]")
    x = np.random.default_rng(45).standard_normal(3 * B).astype(np.complex64)
    tags = [(0, "start"), (B + 1001, "mid", 2.5), (3 * B - 1, "end")]
    fg = Flowgraph(batch_size=B)
    f, snk = filt.fft_filter(taps, decim=2), general.vector_sink()
    fg.connect(general.vector_source(x, tags=tags), 0, f, 0)
    fg.connect(f, 0, snk, 0)
    r = fg.run(device="cuda")
    want = [(0, "start"), ((B + 1001) // 2, "mid"), ((3 * B - 1) // 2, "end")]
    have = [(t.offset, t.key) for t in snk.tags()]
    require(r._chunk is not None and have == want,
            f"tags through fft_filter(decim=2): {have}, want {want}")
    log(f"tags through fft_filter at decim 2, 3 batches in graph mode: {have}")
    return {"ms": ms, "launches": k4, "snr": snr}


def phase_sharded_fir(torch) -> float:
    """46. ShardedFirFilter on 4 logical shards at config #3's width (1024
    taps, fft method, decim 2), two batches of 2^21 with tags: >= 120 dB
    against the unsharded filter on the same stream, tag offsets remapped
    exactly in both batches."""
    from newsched_tpu_torch import bench
    from newsched_tpu_torch.ops import fir
    from newsched_tpu_torch.parallel import ShardedFirFilter, make_mesh
    from newsched_tpu_torch.runtime import tags as tags_mod
    from newsched_tpu_torch.testing import snr_db

    taps, B, D = bench.fft_filter_taps(), FFT_BATCH, 2
    f = ShardedFirFilter(make_mesh(4), taps, decim=D)
    gen = torch.Generator(device="cuda").manual_seed(46)
    x = torch.randn(2 * B, dtype=torch.complex64, device="cuda", generator=gen)
    offs = [[7, B - 3], [11, B // 2 + 1]]
    st, outs, got_offs = f.init_state(), [], []
    for b in range(2):
        k = len(offs[b])
        tb = tags_mod.TagBatch(
            offsets=torch.tensor(offs[b], dtype=torch.int32, device="cuda"),
            keys=torch.zeros(k, dtype=torch.int32, device="cuda"),
            values=torch.zeros(k, tags_mod.VALUE_DIM, device="cuda"),
            valid=torch.ones(k, dtype=torch.bool, device="cuda"))
        y, ot, st = f.step(x[b * B:(b + 1) * B], tb, st)
        outs.append(y)
        got_offs.append(ot.offsets.tolist())
    s, ref = fir.fir_init_state(len(taps), "cuda"), []
    for b in range(2):
        s, y = fir.fir_filter(taps, s, x[b * B:(b + 1) * B], decim=D,
                              method="fft")
        ref.append(y)
    snr = snr_db(torch.cat(ref).cpu().numpy(), torch.cat(outs).cpu().numpy())
    want = [[o // D for o in ob] for ob in offs]
    log(f"ShardedFirFilter, 4 shards, 1024 taps, decim {D}, 2 batches of {B}: "
        f"{snr:.2f} dB vs the unsharded filter (gate {SHARD_GATE_DB}); tag "
        f"offsets {got_offs}")
    require(snr >= SHARD_GATE_DB and got_offs == want,
            f"sharded FIR: {snr:.2f} dB, tags {got_offs} want {want}")
    return snr


def phase_deemph(torch, wb: dict, card: str, k10_ms: float) -> dict:
    """47. Config #1 staged, fused, folded and live with deemph_tau=75e-6,
    4 batches each in graph mode: >= 60 dB against the float64 golden
    followed by a float64 lfilter of the emphasis taps; the de-emphasis
    (fm_deemph's iir_filter at a batch's 104448 audio samples) timed by
    CUDA-graph replay beside K10; the fused step with and without it."""
    import scipy.signal as sig

    from newsched_tpu_torch import bench
    from newsched_tpu_torch.blocks import analog
    from newsched_tpu_torch.ops import iir
    from newsched_tpu_torch.testing import snr_db

    b, a = analog._emphasis_taps(WB_FS / WB_D / WB_RD, DEEMPH_TAU, None, True)
    ref = sig.lfilter(b, a, wb["ref"])
    out = {}
    for kind in ("staged", "fused", "folded", "live"):
        fg, blks = wb_graph(kind, 4, deemph_tau=DEEMPH_TAU)
        r = fg.run(device="cuda")
        got = blks["sink"].data()
        snr = snr_db(ref[:len(got)], got)
        log(f"wbfm {kind} with de-emphasis (tau 75 us), graph mode: "
            f"{len(got)} audio samples, SNR vs float64 golden {snr:.2f} dB "
            f"(gate {WB_GATE_DB})")
        require(r._chunk is not None and snr >= WB_GATE_DB
                and len(got) == 4 * WB_NAUD * 64,
                f"wbfm {kind} de-emphasised: {snr:.2f} dB")
        out[kind] = snr
    ff, fb = iir.lfilter_taps(b, a)
    n = WB_NAUD * 64
    c = iir.iir_consts(ff, fb, n, "cuda")
    s0 = iir.iir_init_state(len(ff), len(fb), "cuda")
    xa = torch.randn(n, device="cuda")
    de_ms = graph_ms(lambda: iir.iir_filter(ff, fb, s0, xa, consts=c))
    steps = {}
    for tau in (None, DEEMPH_TAU):
        sps = bench.timed_two_point(
            bench.graph_run(wb_graph("fused", None, "null",
                                     deemph_tau=tau)[0], "cuda"),
            f"graph mode wbfm fused, deemph {tau}", WB_BATCH, n_best=3,
            k1=GRAPH_K[0], k2=GRAPH_K[1])
        steps[tau] = WB_BATCH / sps * 1e3
    log(f"de-emphasis: iir_filter at {n} audio samples (chunk "
        f"{c.C}, {c.K} chunks) {de_ms:.4f} ms by CUDA-graph replay, beside "
        f"K10 {k10_ms:.4f} ms; wbfm fused graph-mode step {steps[None]:.4f} "
        f"ms, with de-emphasis {steps[DEEMPH_TAU]:.4f} ms [{card}]")
    return {"snr": out, "ms": de_ms, "steps": steps}


def phase_dsp_blocks(torch) -> None:
    """48. The block library's DSP half on the card against its CPU run,
    4 batches in graph mode, within the tolerance of its CPU test: AGC and
    an order-4 Butterworth iir_filter (>= 100 dB), the fft block (1e-6 of
    max|out|), math (1e-6) and streamops (exact) blocks."""
    import scipy.signal as sig

    from newsched_tpu_torch.blocks import analog, fft, filter as filt, \
        general, math, streamops
    from newsched_tpu_torch.ops import iir
    from newsched_tpu_torch.runtime.graph import Flowgraph
    from newsched_tpu_torch.testing import snr_db

    rng = np.random.default_rng(48)
    n, B = 4 * 65536, 65536
    xc = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.2
          ).astype(np.complex64)
    xr = xc.real.copy()
    ff, fb = iir.lfilter_taps(*sig.butter(4, 0.2))

    def chain(x, make, dtype, vlen=(), out_dtype=None, out_vlen=None):
        def run(device):
            fg = Flowgraph(batch_size=B // (vlen[0] if vlen else 1))
            blk = make()
            snk = general.vector_sink(dtype=out_dtype or dtype,
                                      vlen=vlen if out_vlen is None else out_vlen)
            fg.connect(general.vector_source(x, dtype=dtype, vlen=vlen), 0,
                       blk, 0)
            fg.connect(blk, 0, snk, 0)
            fg.run(device=device)
            return snk.data()
        return run("cuda"), run("cpu")

    cases = {
        "agc": (chain(xc, lambda: analog.agc(rate=1e-3), "cf32"), "snr"),
        "iir_filter": (chain(xr, lambda: filt.iir_filter(ff, fb), "rf32"),
                       "snr"),
        "fft": (chain(xc.reshape(-1, 64), lambda: fft.fft(
            64, window=np.blackman(64), shift=True), "cf32", (64,)), "rel"),
        "multiply_const": (chain(xc, lambda: math.multiply_const(0.5 + 1j, "cf32"),
                                 "cf32"), "rel"),
        "complex_to_mag": (chain(xc, math.complex_to_mag, "cf32", (), "rf32"),
                           "rel"),
        "keep_m_in_n": (chain(xc, lambda: streamops.keep_m_in_n(2, 8, 3),
                              "cf32"), "exact"),
        "skiphead": (chain(xc, lambda: streamops.skiphead(70000), "cf32"),
                     "exact"),
        "delay": (chain(xr, lambda: streamops.delay(77, dtype="rf32"),
                        "rf32"), "exact"),
    }
    for name, ((gpu, cpu), how) in cases.items():
        require(gpu.shape == cpu.shape and len(gpu) > 0,
                f"{name}: shapes {gpu.shape} {cpu.shape}")
        if how == "snr":
            v = snr_db(cpu, gpu)
            ok, what = v >= 100, f"{v:.2f} dB (gate 100)"
        elif how == "rel":
            v = float(np.max(np.abs(gpu - cpu)) / np.max(np.abs(cpu)))
            ok, what = v <= 1e-6, f"max err {v:.2e} of max|out| (tol 1e-6)"
        else:
            ok, what = bool(np.array_equal(gpu, cpu)), "bit-equal"
        log(f"block {name} on the card vs its CPU run, 4 batches: {what}")
        require(ok, f"block {name}: {what}")
    from newsched_tpu_torch.ops import agc as agc_ops, analog as analog_ops

    devs = (agc_ops.agc_init_state().gain.device.type,
            analog_ops.rotator_init_state().phase.device.type)
    log(f"agc_init_state() and rotator_init_state() with no argument: on {devs}")
    require(devs == ("cuda", "cuda"), f"state constructors default to {devs}")


K1_DENSE_MS_M320 = 1.6574   # K1 at M = 320 as its dense instance (PERF.md)


def phase_k1_wide(torch, channelizer, noise, card: str) -> dict:
    """49. The channelizer past 256 channels on its main path: the staged
    fm_channelizer (noise_source -> pfb_channelizer -> demod -> audio FIR),
    two batches of 16384 rows in graph mode, counts set to 0 before each,
    at M = 320, 512 and 1024 (pfb_channelize's "auto" launches K1, K7
    never): >= 60 dB against the float64 golden; each graph's step in graph
    mode by the two-point fit (null sink); then pfb_channelize at M = 512,
    960 and 1024 by method="fused" and "auto", each launching K1 once,
    within FOLD_TOL of max|Y| from K7 and the combine; by CUDA-graph replay
    at 16384 rows K1 at M = 320 .. 1024 beside its plain version and bound,
    and at M = 512 and 1024 the two routes "auto" chooses between, K1 and
    K7 + cuFFT's combine, in one alternation."""
    from newsched_tpu_torch import bench
    from newsched_tpu_torch.ops import pfb
    from newsched_tpu_torch.testing import planes_rows, snr_db

    fn = channelizer.arm_fold_dft
    launches, step = {m: 0 for m in K1_WIDE_M}, {}
    launches["K7"] = 0
    for m in STAGED_M:
        batch = DENSE_ROWS * m
        zero_launches()
        fg, blks = wide_graph(m, None, 2, batch, fused=False)
        fg.run(device="cuda")
        n, k7 = fn.launches, channelizer.arm_fold.launches
        r = noise.gaussian_rows_plain(0, n_rows=2 * batch // 64, width=128,
                                      seed=0, device="cuda")
        x = (torch.complex(r[:, :64].reshape(-1), r[:, 64:].reshape(-1))
             * 0.5).cpu().numpy()
        ref, bad = wide_golden(planes_rows(x, m), m, f"staged M={m}")
        got = blks["sink"].data()
        snr = snr_db(ref[~bad], got[~bad])
        _GOLDEN.pop(f"staged M={m}")  # large at M = 1024; used once
        route = pfb.auto_method(m)
        log(f"staged fm_channelizer at M={m}, 2 batches of {batch} in graph "
            f"mode: {snr:.2f} dB vs float64 (gate {STAGED_GATE_DB}); auto "
            f"takes {route}: K1 launched {n} times, K7 {k7}")
        require(snr >= STAGED_GATE_DB and ((n > 0 and k7 == 0) if
                                           route == "fused" else
                                           (k7 > 0 and n == 0)),
                f"staged M={m}: {snr:.2f} dB, or K1 launched {n} times and "
                f"K7 {k7} on the route {route}")
        launches[m] = launches.get(m, 0) + n
        launches["K7"] += k7
        fg, _ = wide_graph(m, None, None, batch, fused=False, sink="null")
        sps = bench.timed_two_point(bench.graph_run(fg, "cuda"),
                                    f"graph mode staged M={m}", batch,
                                    n_best=3, k1=8, k2=32)
        step[m] = batch / sps * 1e3
        log(f"cell staged fm_channelizer at M={m}: graph mode "
            f"{step[m]:.4f} ms a batch of {batch} samples = "
            f"{sps / 1e6:.1f} Msamples/s ({route}) [{card}]")
    # pfb_channelize by name and by "auto" at the run-time instance's widths
    for m in (512, 960, 1024):
        arm = pfb.pfb_arm_taps(wide_design(m)[0], m)
        pc = pfb.pfb_consts(arm, "cuda")
        g = torch.Generator(device="cuda").manual_seed(m + 1)
        xs = torch.randn(DENSE_ROWS * m, dtype=torch.complex64, device="cuda",
                         generator=g)
        _, yr = pfb.pfb_channelize(arm, pfb.pfb_init_state(m * L, "cuda"), xs,
                                   method="pallas", consts=pc)
        for method in ("fused", "auto"):
            zero_launches()
            _, y = pfb.pfb_channelize(arm, pfb.pfb_init_state(m * L, "cuda"),
                                      xs, method=method, consts=pc)
            n, k7 = fn.launches, channelizer.arm_fold.launches
            launches[m] += n
            launches["K7"] += k7
            err = float((y - yr).abs().max()) / float(yr.abs().max())
            want = "fused" if method == "fused" else pfb.auto_method(m)
            log(f"pfb_channelize(method=\"{method}\") at M={m}, {DENSE_ROWS} "
                f"rows ({want}): K1 launched {n} times, K7 {k7}; {err:.3e} of "
                f"max|Y| from K7 and the combine (tol {FOLD_TOL})")
            require((n, k7) == ((1, 0) if want == "fused" else (0, 1))
                    and err <= FOLD_TOL,
                    f"method={method} at M={m}: K1 launched {n} times, K7 "
                    f"{k7}, {err:.3e} from K7 and the combine")
    ms, bounds = {}, {}
    for m in K1_WIDE_M:
        taps, _ = wide_design(m)
        pc = pfb.pfb_consts(pfb.pfb_arm_taps(taps, m), "cuda")
        g = torch.Generator(device="cuda").manual_seed(m)
        v = torch.randn(DENSE_ROWS + L - 1, 2 * m, device="cuda", generator=g)
        kid = f"K1 M={m}"
        t = alternate({
            kid + " plain": lambda: channelizer.arm_fold_dft_plain(
                v, pc.c2, pc.w2, DENSE_ROWS),
            kid: lambda: fn(v, pc.c2, pc.w2, DENSE_ROWS, fft=pc.fft)},
            PLAIN_REPS)
        ms.update({k: min(x_) for k, x_ in t.items()})
        bounds[kid] = b_ms, by = chain_bounds(m, DENSE_ROWS, DENSE_ROWS)["K1"]
        was = (f"; its dense instance there before {K1_DENSE_MS_M320} ms "
               f"(PERF.md), {K1_DENSE_MS_M320 / ms[kid]:.1f}x"
               if m == K1_WIDE_M[0] else "")
        log(f"K1 arm_fold_dft at M={m} ({DENSE_ROWS} x {2 * m} rows, "
            f"{'run-time P' if m > 448 else 'FFT'} instance): kernel "
            f"{t[kid]} ms, plain {t[kid + ' plain']} ms; bound {b_ms:.4f} ms "
            f"({by}), {100 * b_ms / ms[kid]:.1f}% of it{was} [{card}]")
    # the two routes "auto" chooses between: K1 at every P = 8 .. 16 bit for
    # bit the FFT replay of K7's output and within FOLD_TOL of its plain
    # version; at ROUTE_TIMED both in one alternation a width
    for m in ROUTE_M:
        taps, _ = wide_design(m)
        pc = pfb.pfb_consts(pfb.pfb_arm_taps(taps, m), "cuda")
        g = torch.Generator(device="cuda").manual_seed(m)
        v = torch.randn(DENSE_ROWS + L - 1, 2 * m, device="cuda", generator=g)
        got = fn(v, pc.c2, pc.w2, DENSE_ROWS, fft=pc.fft)
        rep = channelizer.fft_interleaved(
            channelizer.arm_fold(v, pc.c2, DENSE_ROWS), pc.fft)
        ref = channelizer.arm_fold_dft_plain(v, pc.c2, pc.w2, DENSE_ROWS)
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        same = torch.equal(got, rep)
        log(f"K1 at M={m} (P = {m // 64}), {DENSE_ROWS} rows: bit-equal to "
            f"the FFT replay of K7's output: {same}; {err:.3e} of max|out| "
            f"from its plain version (tol {FOLD_TOL})")
        require(same and err <= FOLD_TOL,
                f"K1 at M={m}: differs from the replay of K7's output, or "
                f"{err:.3e} from its plain version")
        if m not in ROUTE_TIMED:
            continue
        t = alternate({
            "K1": lambda: fn(v, pc.c2, pc.w2, DENSE_ROWS, fft=pc.fft),
            "K7+fft": lambda: pfb._phase_combine(
                channelizer.interleaved_to_complex(
                    channelizer.arm_fold(v, pc.c2, DENSE_ROWS)), pc, "fft")},
            3)
        k1, k7 = min(t["K1"]), min(t["K7+fft"])
        ms[f"route K1 M={m}"], ms[f"route K7+fft M={m}"] = k1, k7
        log(f"routes at M={m}, {DENSE_ROWS} rows: K1 {t['K1']} ms, K7 + "
            f"cuFFT's combine {t['K7+fft']} ms; auto takes "
            f"{pfb.auto_method(m)}, the faster here "
            f"{'fused' if k1 <= k7 else 'pallas'} [{card}]")
    return {"launches": launches, "ms": ms, "bound": bounds, "step": step}


# -- the digital and FEC half: S1-S3, the QPSK link, the FEC link ------------

LOOP_N = 32768             # samples a stream of phase 50's loops
LOOP_STREAMS = (1, 64)
LOOP_TOL = 1e-4            # S1/S2 vs plain, of max|y|: sincosf vs torch sin/cos
QPSK_SPS = 4
QPSK_BATCH = 1 << 20       # received samples a batch (262,144 symbols)
QPSK_BATCHES = 8           # one captured chunk (runner.GRAPH_CHUNK steps)
QPSK_LAG, QPSK_SETTLE = 11, 2000  # symbol k + LAG received is k sent
FEC_FRAME, FEC_K = 512, 7
FEC_FRAMES = 1024          # frames a batch of the FEC link
FEC_BATCHES = 8            # one captured chunk (runner.GRAPH_CHUNK steps)
FEC_SIGMA_7DB = 0.447      # Eb/N0 = 1 / (2 R sigma^2) = 7 dB at rate 1/2
FEC_SIGMA_REF = 0.65       # tests/test_fec.py:54's channel, ~3.7 dB
# The serial floor of S1 and S2: the dependent instructions on a step's
# critical path (the loop-carried chain: phase -> phase for S1, pos and mu
# -> pos and mu for S2), by class, times each class's latency in SM
# cycles, times the steps, at the card's maximum SM clock. The latencies
# are assumptions from published Hopper microbenchmarks, not measured here:
# a dependent FP32/INT32 ALU operation 4 cycles, a shared-memory load 30, a
# float->int64 conversion 12, CUDA's IEEE sincosf ~20 dependent FP32
# operations (Cody-Waite reduction and two polynomials) and its IEEE
# __fdiv_rn ~8 (reciprocal, Newton steps, the fix-up).
LAT_CYCLES = {"alu": 4, "lds": 30, "f2i": 12}
SERIAL_PATH = {
    # -phase, sincosf 20, the rotation 2, the detector 3, clamp 2, freq
    # (mul, add, clamp 2), phase 2 adds, the wrap (div 8, rint, mul, sub)
    "S1": {"alu": 1 + 20 + 2 + 3 + 2 + 4 + 2 + 11},
    # pos clamp 2 and slice offset 2 (64-bit), the load, interpolation 3,
    # error 4, clamp 2, omega 5 with its clamp, step 2, floor, mu; the
    # floor's conversion and the 64-bit add
    "S2": {"alu": 4 + 3 + 4 + 2 + 5 + 2 + 2 + 2, "lds": 1, "f2i": 1},
}


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def serial_floor_ns(kid: str, mhz: float) -> float:
    """ns a step of one stream's critical path (SERIAL_PATH x LAT_CYCLES)."""
    cycles = sum(n * LAT_CYCLES[c] for c, n in SERIAL_PATH[kid].items())
    return cycles / mhz * 1e3


def psk_streams(order: int, C: int, n: int, seed: int) -> np.ndarray:
    """C streams of the detector's own constellation (BPSK, diagonal QPSK,
    8PSK), rotated 0.3 rad with a slow drift, with noise far from the
    decision boundaries."""
    rng = np.random.default_rng(seed)
    rot = {2: 0.0, 4: np.pi / 4, 8: 0.0}[order]
    k = rng.integers(0, order, (C, n))
    s = np.exp(1j * (2 * np.pi * k / order + rot + 0.3 + 2e-5 * np.arange(n)))
    s = s + 0.05 * (rng.standard_normal(s.shape) + 1j * rng.standard_normal(s.shape))
    return s.astype(np.complex64)


def rrc_streams(C: int, n: int, seed: int, sps: int = QPSK_SPS) -> np.ndarray:
    """C streams of diagonal QPSK through the link's RRC shaper at sps,
    0.4 sample late, with a little noise (the M&M loop's input)."""
    from newsched_tpu_torch.models import rrc_taps

    rng = np.random.default_rng(seed)
    taps = rrc_taps(sps)
    k = rng.integers(0, 4, (C, n // sps + len(taps)))
    up = np.zeros((C, k.shape[1] * sps), np.complex128)
    up[:, ::sps] = np.exp(1j * (np.pi / 2 * k + np.pi / 4))
    x = np.stack([np.convolve(u, taps)[len(taps):len(taps) + n + 1] for u in up])
    x = x[:, :-1] + 0.4 * (x[:, 1:] - x[:, :-1])
    x = x + 0.02 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def loop_ms(fn) -> float:
    """Device time of one call of a loop kernel (CUDA-graph replay, 3 calls
    a graph, median of 5): a call runs for milliseconds."""
    return graph_ms(fn, reps=5, inner=3)


def phase_loops(torch, kloops, card: str) -> dict:
    """50. S1 and S2 against their plain versions (run on the CPU, its loop
    of torch ops on the same inputs) at LOOP_N samples, C = 1 and 64
    streams: S1 at orders 2, 4, 8 on each detector's constellation, S2 at
    sps 4: outputs within LOOP_TOL of max|y|, the carried state within the
    same, S1's decisions (constellation_decoder's) identical; two batches
    bit-equal to one; each kernel's time beside its bytes bound and its
    serial floor."""
    from newsched_tpu_torch.blocks import digital
    from newsched_tpu_torch.ops import loops

    const = {2: digital.Constellation.bpsk(),
             4: digital.Constellation.psk(4, rot=np.pi / 4),
             8: digital.Constellation.psk(8)}
    a, b = loops.loop_coeffs(0.06)
    bw = torch.tensor(0.06, dtype=torch.float32, device="cuda")
    errs = {"S1": 0.0, "S2": 0.0}
    out = {"t": {}, "plain": {}}
    for C in LOOP_STREAMS:
        for order in (2, 4, 8):
            x = torch.from_numpy(psk_streams(order, C, LOOP_N, seed=order + C))
            z = torch.zeros(C)
            z_ph = torch.full((C,), 0.1)
            t0 = time.monotonic()
            yp, php, frp = kloops.costas_loop_plain(x, z_ph, z, None, float(a),
                                                    float(b), order, 1.0)
            plain_s = time.monotonic() - t0
            xc, zc, phc = x.cuda(), z.cuda(), z_ph.cuda()
            yk, phk, frk = kloops.costas_loop(xc, phc, zc, None, float(a),
                                              float(b), order, 1.0)
            h = LOOP_N // 2 + 37
            y1, ph1, fr1 = kloops.costas_loop(xc[:, :h].contiguous(), phc, zc,
                                              None, float(a), float(b), order, 1.0)
            y2, ph2, fr2 = kloops.costas_loop(xc[:, h:].contiguous(), ph1, fr1,
                                              None, float(a), float(b), order, 1.0)
            # the settable form: loop_bw a tensor on the card
            yt, _, _ = kloops.costas_loop(xc, phc, zc, bw, 0.0, 0.0, order, 1.0)
            ytp, _, _ = kloops.costas_loop_plain(x[:1, :4096], z_ph[:1], z[:1],
                                                 torch.tensor(0.06), 0.0, 0.0,
                                                 order, 1.0)
            torch.cuda.synchronize()
            err = float((yk.cpu() - yp).abs().max() / yp.abs().max())
            st_err = max(float((phk.cpu() - php).abs().max()),
                         float((frk.cpu() - frp).abs().max()))
            terr = float((yt[:1, :4096].cpu() - ytp).abs().max() / ytp.abs().max())
            dk = const[order].decide(yk.reshape(-1)).cpu()
            dp = const[order].decide(yp.reshape(-1))
            flips = int((dk != dp).sum())
            split = (torch.equal(torch.cat([y1, y2], 1), yk)
                     and torch.equal(ph2, phk) and torch.equal(fr2, frk))
            log(f"S1 costas_loop order {order}, C = {C}, {LOOP_N} samples: "
                f"{err:.2e} of max|y| from its plain version (loop_bw on the "
                f"card: {terr:.2e} over 4096), state {st_err:.2e}, decisions "
                f"flipped {flips}, two batches bit-equal to one: {split}; plain "
                f"version {plain_s:.1f} s on the CPU")
            require(err <= LOOP_TOL and st_err <= LOOP_TOL and terr <= LOOP_TOL
                    and flips == 0 and split,
                    f"S1 order {order} C {C}: err {err}, state {st_err}, "
                    f"tensor bw {terr}, flips {flips}, split {split}")
            errs["S1"] = max(errs["S1"], err)
            if order == 4:
                out["t"][f"S1 C={C}"] = loop_ms(lambda: kloops.costas_loop(
                    xc, phc, zc, bw, 0.0, 0.0, 4, 1.0))
                out["plain"][f"S1 C={C}"] = plain_s * 1e3
        sps = QPSK_SPS
        x = torch.from_numpy(rrc_streams(C, LOOP_N, seed=50 + C))
        st = loops.mm_init_state(sps, device="cpu")
        args = [t.expand(C, *t.shape).contiguous() for t in st]
        gains = (torch.tensor(0.25 * 0.1 * 0.1, dtype=torch.float32),
                 torch.tensor(0.1, dtype=torch.float32))
        t0 = time.monotonic()
        outp = kloops.clock_recovery_mm_plain(x, *args, sps, *gains, 0.005)
        plain_s = time.monotonic() - t0
        xc, argc = x.cuda(), [t.cuda() for t in args]
        gc = tuple(g.cuda() for g in gains)
        outk = kloops.clock_recovery_mm(xc, *argc, sps, *gc, 0.005)
        h = LOOP_N // 2 + 36  # a multiple of sps
        o1 = kloops.clock_recovery_mm(xc[:, :h].contiguous(), *argc, sps, *gc,
                                      0.005)
        o2 = kloops.clock_recovery_mm(xc[:, h:].contiguous(), *o1[1:], sps, *gc,
                                      0.005)
        torch.cuda.synchronize()
        yk, yp = outk[0].cpu(), outp[0]
        err = float((yk - yp).abs().max() / yp.abs().max())
        # pos + mu, not pos alone: a 1-ulp step can move floor(step) by one
        pm = float((outk[2].cpu() + outk[3].cpu().double()
                    - outp[2] - outp[3].double()).abs().max())
        st_err = max([pm] + [float((k.cpu() - p).abs().max())
                             for k, p in zip(outk[4:], outp[4:])])
        bit_equal = all(torch.equal(k.cpu(), p) for k, p in zip(outk, outp))
        split = (torch.equal(torch.cat([o1[0], o2[0]], 1), outk[0])
                 and all(torch.equal(p, q) for p, q in zip(o2[1:], outk[1:])))
        log(f"S2 clock_recovery_mm sps {sps}, C = {C}, {LOOP_N} samples: "
            f"{err:.2e} of max|y| from its plain version, state {st_err:.2e} "
            f"(pos + mu), bit-equal to it: {bit_equal}; two batches bit-equal "
            f"to one: {split}; plain version {plain_s:.1f} s on the CPU")
        require(err <= LOOP_TOL and st_err <= LOOP_TOL and split,
                f"S2 C {C}: err {err}, state {st_err}, split {split}")
        errs["S2"] = max(errs["S2"], err)
        out["t"][f"S2 C={C}"] = loop_ms(lambda: kloops.clock_recovery_mm(
            xc, *argc, sps, *gc, 0.005))
        out["plain"][f"S2 C={C}"] = plain_s * 1e3
    mhz = sm_clock_mhz()
    out["bounds"] = {}
    for kid, steps_of in (("S1", lambda n: n), ("S2", lambda n: n // QPSK_SPS)):
        floor_ns = serial_floor_ns(kid, mhz)
        for C in LOOP_STREAMS:
            key = f"{kid} C={C}"
            ms = out["t"][key]
            nbytes = C * LOOP_N * 8 + C * steps_of(LOOP_N) * 8
            b_ms, by = bound(nbytes, 0)
            floor_ms = floor_ns * steps_of(LOOP_N) * 1e-6
            out["bounds"][key] = (max(b_ms, floor_ms),
                                  "serial" if floor_ms > b_ms else by, b_ms,
                                  floor_ms)
            log(f"{key}: {ms:.4f} ms = {ms * 1e6 / steps_of(LOOP_N):.1f} ns a "
                f"step ({C * steps_of(LOOP_N) / ms / 1e3:.1f} M steps/s over "
                f"the streams); bytes bound {b_ms:.5f} ms, serial floor "
                f"{floor_ns:.1f} ns a step = {floor_ms:.4f} ms ({mhz:.0f} MHz), "
                f"{100 * floor_ms / ms:.1f}% of it; plain "
                f"{out['plain'][key]:.0f} ms [{card}]")
    out["err"] = errs
    return out


def fec_llrs(torch, n_frames: int, sigma: float, seed: int, K: int = FEC_K,
             polys=(0o171, 0o133), hard: bool = False, nbits: int = FEC_FRAME):
    """Frames of nbits random bits, encoded (ops/fec.py), +-1 plus AWGN;
    the LLRs (hard: the slicer's +-1), the bits and the raw coded-bit
    errors."""
    from newsched_tpu_torch.ops import fec

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_frames, nbits))
    coded = fec.conv_encode(torch.from_numpy(bits), polys, K).numpy()
    rx = (2.0 * coded - 1.0 + rng.normal(0, sigma, coded.shape)).astype(np.float32)
    llr = np.where(rx > 0, 1.0, -1.0).astype(np.float32) if hard else rx
    return llr, bits, int(((rx > 0) != (coded > 0)).sum())


S3_CODES = (((0o171, 0o133), 7), ((0o7, 0o5), 3), ((0o2565, 0o3753), 11))
# S3 before its warp instance (one block a frame, a barrier a step; PERF.md
# section 6): 1024 frames, ns a step of one frame alone, the FEC link's step
S3_BLOCK = {"ms": 0.2189, "one frame ns": 368.3, "link ms": 0.3470}


def phase_viterbi(torch, kfec, card: str) -> dict:
    """51. S3 against its plain version (on the card) at 1024 frames of 512
    bits, K = 7 (171/133) and K = 3 (7/5) on its warp instance and K = 11
    (2565/3753) on its block instance, hard and soft LLRs, each launch
    counted on its instance's count: decoded bits bit-equal; zero errors
    on the noiseless code and with four separated coded bits flipped a
    frame (tests/test_fec.py:41); its time at 1024 frames and at one (a
    step's latency) beside the block-a-frame design's and its bound."""
    from newsched_tpu_torch.ops import fec

    vf = kfec.viterbi_frames
    for polys, K in S3_CODES:
        tabs = fec.viterbi_tables(polys, K, "cuda")
        inst = kfec.viterbi_instance(K, len(polys))
        count = "launches" if inst == "warp" else "block_launches"
        for kind, sigma in (("hard", 0.8), ("soft", 0.8), ("noiseless", 0.0),
                            ("4 flips", 0.0)):
            llr, bits, _ = fec_llrs(torch, FEC_FRAMES, sigma, seed=51 + K,
                                    K=K, polys=polys, hard=kind != "soft")
            if kind == "4 flips":
                llr[:, [17, 150, 301, 450]] *= -1
            lc = torch.from_numpy(llr).cuda().reshape(FEC_FRAMES, -1, 2)
            before = getattr(vf, count)
            got = vf(lc, tabs, K, True)
            ref = kfec.viterbi_frames_plain(lc, tabs, True, FEC_FRAME)
            equal = torch.equal(got, ref)
            errors = int((got.cpu().numpy() != bits).sum())
            log(f"S3 viterbi_decode K = {K}, {kind}, {FEC_FRAMES} frames of "
                f"{FEC_FRAME} bits, {inst} instance: bit-equal to its plain "
                f"version: {equal}; {errors} bit errors")
            require(getattr(vf, count) == before + 1,
                    f"S3 K {K}: the {inst} instance was not counted")
            require(equal, f"S3 K {K} {kind}: differs from its plain version")
            require(kind in ("hard", "soft") or errors == 0,
                    f"S3 K {K} {kind}: {errors} bit errors")
    tabs = fec.viterbi_tables((0o171, 0o133), FEC_K, "cuda")
    llr, _, _ = fec_llrs(torch, FEC_FRAMES, 0.8, seed=510)
    lc = torch.from_numpy(llr).cuda().reshape(FEC_FRAMES, -1, 2)
    one = lc[:1].contiguous()
    t = {"S3": graph_ms(lambda: vf(lc, tabs, FEC_K, True)),
         "S3 one frame": graph_ms(lambda: vf(one, tabs, FEC_K, True)),
         "S3 plain": median_ms(lambda: kfec.viterbi_frames_plain(
             lc, tabs, True, FEC_FRAME), reps=3, inner=1)}
    T, S = lc.shape[1], 1 << (FEC_K - 1)
    b_ms, by = bound(lc.numel() * 4 + FEC_FRAMES * FEC_FRAME * 4,
                     FEC_FRAMES * T * S * VITERBI_OPS)
    log(f"S3 viterbi_decode ({FEC_FRAMES} x {T} steps, {S} states): kernel "
        f"{t['S3']:.4f} ms = {t['S3'] * 1e6 / T:.1f} ns a step of every frame "
        f"at once; one frame {t['S3 one frame']:.4f} ms = "
        f"{t['S3 one frame'] * 1e6 / T:.1f} ns a step; the block-a-frame "
        f"design {S3_BLOCK['ms']} ms, one frame {S3_BLOCK['one frame ns']} ns "
        f"a step; "
        f"plain {t['S3 plain']:.2f} ms; bound {b_ms:.4f} ms ({by}), "
        f"{100 * b_ms / t['S3']:.1f}% of it [{card}]")
    return {"t": t, "bound": (b_ms, by)}


# ACS a state a step at rate 1/2: two branch metrics (2 products, 1 add
# each), the previous max subtracted twice, two adds, a compare, a max
VITERBI_OPS = 2 * 3 + 2 + 2 + 1 + 1


def viterbi_ops(n: int) -> int:
    """VITERBI_OPS at rate 1/n: each branch metric n products, n - 1 adds."""
    return 2 * (2 * n - 1) + 2 + 2 + 1 + 1


# S3's routes past the FEC link's frames and codes (phase 51): name, code,
# K, frame bits, frames a batch of its link, its (instance, memory), and a
# frame length of the same code past shared memory (device memory)
S3_ROUTES = (
    ("global", (0o171, 0o133), 7, 16384, 16, ("warp", "global"), None),
    ("n=5", (0o171, 0o133, 0o165, 0o117, 0o127), 7, FEC_FRAME, 256,
     ("block", "shared"), 8192),
    ("K=12", (0o4037, 0o5741), 12, FEC_FRAME, 256, ("block", "shared"), 1024),
    # past K = 15 the metrics too in device memory (2^K x 4 bytes a frame);
    # 16 frames a batch keep the plain version's (T, F, 2^15) decisions in
    # 2.2 GB
    ("K=16", (0o152711, 0o126723), 16, FEC_FRAME, 16, ("block", "global"),
     None),
)


def phase_viterbi_routes(torch, kfec, card: str) -> dict:
    """51 (continued). S3 past the FEC link's frames and codes, each route
    on its user path: a FEC link (cc_encoder -> BPSK + AWGN at sigma 0.6 ->
    cc_decoder) of two batches in graph mode, the decoded bits bit-equal
    to the plain version on the same LLRs, each launch counted on its
    instance (and its route, global_launches); then direct calls on noisy
    hard and soft frames of the code at its link's length and past shared
    memory, bit-equal to the plain version; each route's time at its
    link's batch beside its plain version and bound."""
    from newsched_tpu_torch.ops import fec

    vf = kfec.viterbi_frames
    out = {"launches": {}, "t": {}, "bound": {}}
    rng = np.random.default_rng(511)
    for name, polys, K, frame, F, plan, long_frame in S3_ROUTES:
        n = len(polys)
        T = frame + K - 1
        require(kfec.viterbi_plan(T, n, K) == plan,
                f"S3 {name}: plans {kfec.viterbi_plan(T, n, K)}, not {plan}")
        tabs = fec.viterbi_tables(polys, K, "cuda")
        bits = rng.integers(0, 2, 2 * F * frame).astype(np.int16)
        noise = (0.6 * rng.standard_normal(2 * F * T * n)).astype(np.float32)
        zero_launches()
        fg, snk = fec_link(bits, noise, batch_frames=F, frame=frame, K=K,
                           polys=polys)
        fg.run(device="cuda")
        count = "launches" if plan[0] == "warp" else "block_launches"
        got_l = (getattr(vf, count), vf.global_launches)
        out["launches"][name] = got_l[0]
        coded = fec.conv_encode(torch.from_numpy(bits.reshape(2 * F, -1))
                                .to(torch.int32), polys, K).numpy()
        llr = (2.0 * coded.astype(np.float32) - 1.0
               + noise.reshape(2 * F, -1)).reshape(2, F, T, n)
        ref = np.concatenate([kfec.viterbi_frames_plain(
            torch.from_numpy(part).cuda(), tabs, True, frame).cpu().numpy()
            for part in llr]).reshape(-1)
        got = snk.data().astype(np.int32)
        log(f"S3 {name} ({K = }, rate 1/{n}, {frame}-bit frames, {plan}): a "
            f"FEC link of 2 batches of {F} frames in graph mode bit-equal to "
            f"the plain version: {np.array_equal(got, ref)}; {count} "
            f"{got_l[0]}, global_launches {got_l[1]}; "
            f"{int((got != bits).sum())} bit errors")
        require(np.array_equal(got, ref) and got_l[0] > 0 and
                (got_l[1] > 0) == (plan[1] == "global"),
                f"S3 {name}: the link differs from the plain version, or its "
                f"route was not counted")
        if K > kfec.SMEM_MAX_K:  # the metrics in device memory, at 7 dB
            before = vf.metric_launches
            llr7, bits7, raw7 = fec_llrs(torch, F, FEC_SIGMA_7DB, seed=K, K=K,
                                         polys=polys, nbits=frame)
            lc7 = torch.from_numpy(llr7).cuda().reshape(F, T, n)
            got7 = vf(lc7, tabs, K, True)
            eq7 = torch.equal(got7, kfec.viterbi_frames_plain(lc7, tabs, True,
                                                              frame))
            errs7 = int((got7.cpu().numpy() != bits7).sum())
            log(f"S3 {name} at 7 dB, {F} frames of {frame} bits: bit-equal "
                f"to the plain version: {eq7}; {errs7} bit errors ({raw7} "
                f"coded bits wrong); metric_launches "
                f"{vf.metric_launches - before}")
            require(eq7 and errs7 == 0 and vf.metric_launches == before + 1,
                    f"S3 {name} at 7 dB: differs from the plain version, "
                    f"{errs7} bit errors, or its metrics route not counted")
        for frames, nb in ((F, frame), (4, long_frame)):
            if nb is None:
                continue
            Tn = nb + K - 1
            for hard in (True, False):
                llr_d, _, _ = fec_llrs(torch, frames, 0.8, seed=nb + K,
                                       K=K, polys=polys, hard=hard, nbits=nb)
                lc = torch.from_numpy(llr_d).cuda().reshape(frames, Tn, n)
                before = vf.global_launches
                equal = torch.equal(vf(lc, tabs, K, True),
                                    kfec.viterbi_frames_plain(lc, tabs, True, nb))
                route = kfec.viterbi_plan(Tn, n, K)
                log(f"S3 {name}: {frames} frames of {nb} bits, "
                    f"{'hard' if hard else 'soft'}, {route}: bit-equal to "
                    f"the plain version: {equal}")
                require(equal and (vf.global_launches == before + 1)
                        == (route[1] == "global"),
                        f"S3 {name} at {nb} bits: differs from the plain "
                        f"version, or its route was not counted")
        llr_t, _, _ = fec_llrs(torch, F, 0.8, seed=K, K=K, polys=polys,
                               nbits=frame)
        lc = torch.from_numpy(llr_t).cuda().reshape(F, T, n)
        key = f"S3 {name}"
        out["t"][key] = graph_ms(lambda: vf(lc, tabs, K, True))
        out["t"][key + " plain"] = median_ms(lambda: kfec.viterbi_frames_plain(
            lc, tabs, True, frame), reps=3, inner=1, warmup=1)
        S = 1 << (K - 1)
        b_ms, by = bound(lc.numel() * 4 + F * frame * 4,
                         F * T * S * viterbi_ops(n))
        out["bound"][key] = (b_ms, by)
        log(f"S3 {name} ({F} x {T} steps, {S} states, rate 1/{n}, {plan}): "
            f"kernel {out['t'][key]:.4f} ms = "
            f"{out['t'][key] * 1e6 / T:.1f} ns a step of every frame at "
            f"once; plain {out['t'][key + ' plain']:.2f} ms; bound "
            f"{b_ms:.4f} ms ({by}), {100 * b_ms / out['t'][key]:.1f}% of it "
            f"[{card}]")
    return out


def qpsk_symbols(n_batches: int = QPSK_BATCHES + 1) -> np.ndarray:
    """The link's symbols (seeded): n_batches of QPSK_BATCH samples' worth
    (one more than phase 52's run, for its 17 batches of 2^18)."""
    n_sym = n_batches * QPSK_BATCH // QPSK_SPS
    return np.random.default_rng(52).integers(0, 4, n_sym).astype(np.int32)


def qpsk_channel(tx: np.ndarray) -> np.ndarray:
    """The received stream: a 0.5-sample fractional delay (a linear phase
    across the spectrum), a 0.3 rad carrier phase and AWGN at 20 dB of the
    signal's power, where the reference locks."""
    f = np.fft.fftfreq(len(tx))
    y = np.fft.ifft(np.fft.fft(tx) * np.exp(-2j * np.pi * f * 0.5)) * np.exp(0.3j)
    rng = np.random.default_rng(520)
    s = np.sqrt(np.mean(np.abs(y) ** 2) / 10 ** 2.0 / 2)
    y = y + s * (rng.standard_normal(len(y)) + 1j * rng.standard_normal(len(y)))
    return y.astype(np.complex64)


def qpsk_stream(torch):
    """The symbols, sent by qpsk_tx on the card (graph mode), and the
    received stream."""
    from newsched_tpu_torch.models import qpsk_tx

    syms = qpsk_symbols()
    fg, b = qpsk_tx(syms, sps=QPSK_SPS, batch_size=QPSK_BATCH // QPSK_SPS)
    fg.run(device="cuda")
    tx = b["sink"].data()
    require(tx.shape == (len(syms) * QPSK_SPS,) and np.isfinite(tx).all(),
            f"qpsk_tx: {tx.shape}")
    return syms, qpsk_channel(tx)


# The received symbols (indices from the stream's start) that differ from
# the sent ones at the lag, from QPSK_SETTLE on, when the REFERENCE's
# qpsk_tx and qpsk_receiver (newsched_tpu.models.qpsk) run phase 52's
# stream (8 batches of 2^20 samples): 36 in 2,095,141, in 11 bursts of 2
# to 9 errors within at most 14 symbols, the receiver locked between them
# (the differential decoder turns one wrong decision into two). tests/test_torch_qpsk.py::
# test_chip_smoke_link_errors_are_the_references recomputes them from the
# reference. The reference is not error-free at this length, so phase 52
# holds the port to the reference's own errors, symbol for symbol.
QPSK_REF_ERRORS = (
    100279, 100280, 169230, 169231, 536893, 536895, 536898, 536899, 536905,
    536906, 1023056, 1023058, 1194927, 1194928, 1276517, 1276518, 1276520,
    1276521, 1285648, 1285649, 1285650, 1285651, 1452918, 1452921, 1452922,
    1706010, 1706012, 1875339, 1875341, 1875343, 1875344, 1875345, 1875346,
    1875347, 1875350, 1875351)


def qpsk_errors(got: np.ndarray, syms: np.ndarray) -> tuple:
    """Indices of the received symbols from QPSK_SETTLE + QPSK_LAG on that
    differ from the sent ones at the lag."""
    n = len(got)
    ok = got[QPSK_SETTLE + QPSK_LAG:] == syms[QPSK_SETTLE:n - QPSK_LAG]
    return tuple(int(i) + QPSK_SETTLE + QPSK_LAG for i in np.nonzero(~ok)[0])


def qpsk_check(got: np.ndarray, syms: np.ndarray, what: str) -> None:
    """The received symbols equal the sent ones at the lag from symbol
    QPSK_SETTLE on, but where the reference's receiver errs on the same
    stream (QPSK_REF_ERRORS): there the port errs too, and nowhere else."""
    err = qpsk_errors(got, syms)
    bs = QPSK_BATCH // QPSK_SPS
    per_batch = [sum(1 for i in err if b <= i < b + bs)
                 for b in range(0, len(got), bs)]
    ref = [sum(1 for i in QPSK_REF_ERRORS if b <= i < b + bs)
           for b in range(0, len(got), bs)]
    log(f"{what}: symbol errors from symbol {QPSK_SETTLE} at lag {QPSK_LAG}, "
        f"batch by batch: {per_batch} in {len(got) - QPSK_SETTLE - QPSK_LAG} "
        f"(the reference's on this stream: {ref}); at the reference's "
        f"symbols: {err == QPSK_REF_ERRORS}")
    require(err == QPSK_REF_ERRORS,
            f"{what}: symbol errors at {err[:20]}..., not the reference's")


def loops_on_main_path_shapes(torch, kloops, card: str) -> dict:
    """52a. S2 and S1 at the shapes the QPSK link gives them (one stream; S2
    a batch of 2^20 samples, S1 its 262,144 symbols) against their plain
    versions (on the CPU) within LOOP_TOL, S1's decisions identical; each
    kernel's time there (the kernels line's) beside its bound and serial
    floor, and its plain version's."""
    from newsched_tpu_torch.models import qpsk_constellation
    from newsched_tpu_torch.ops import loops

    n_sym = QPSK_BATCH // QPSK_SPS
    x2 = torch.from_numpy(rrc_streams(1, QPSK_BATCH, seed=521))
    st = [t.expand(1, *t.shape).contiguous()
          for t in loops.mm_init_state(QPSK_SPS, device="cpu")]
    g = (torch.tensor(0.25 * 0.1 * 0.1, dtype=torch.float32),
         torch.tensor(0.1, dtype=torch.float32))
    x1 = torch.from_numpy(psk_streams(4, 1, n_sym, seed=522))
    z = torch.zeros(1)
    bw = torch.tensor(0.06, dtype=torch.float32)
    plain, t0 = {}, time.monotonic()
    p2 = kloops.clock_recovery_mm_plain(x2, *st, QPSK_SPS, *g, 0.005)
    plain["S2"] = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    p1 = kloops.costas_loop_plain(x1, z, z, bw, 0.0, 0.0, 4, 1.0)
    plain["S1"] = (time.monotonic() - t0) * 1e3
    c2 = (x2.cuda(), *[t.cuda() for t in st])
    gc = tuple(t.cuda() for t in g)
    c1 = (x1.cuda(), z.cuda(), z.cuda(), bw.cuda())
    k2 = kloops.clock_recovery_mm(*c2, QPSK_SPS, *gc, 0.005)
    k1 = kloops.costas_loop(*c1, 0.0, 0.0, 4, 1.0)
    torch.cuda.synchronize()
    err = {"S2": float((k2[0].cpu() - p2[0]).abs().max() / p2[0].abs().max()),
           "S1": float((k1[0].cpu() - p1[0]).abs().max() / p1[0].abs().max())}
    const = qpsk_constellation()
    flips = int((const.decide(k1[0].reshape(-1)).cpu()
                 != const.decide(p1[0].reshape(-1))).sum())
    ms = {"S2": loop_ms(lambda: kloops.clock_recovery_mm(*c2, QPSK_SPS, *gc,
                                                         0.005)),
          "S1": loop_ms(lambda: kloops.costas_loop(*c1, 0.0, 0.0, 4, 1.0))}
    mhz = sm_clock_mhz()
    bounds = {"S2": bound(QPSK_BATCH * 8 + n_sym * 8, MM_OPS * n_sym),
              "S1": bound(n_sym * 16, COSTAS_OPS * n_sym)}
    for kid, what, steps in (("S2", "clock_recovery_mm", n_sym),
                             ("S1", "costas_loop", n_sym)):
        floor_ms = serial_floor_ns(kid, mhz) * steps * 1e-6
        log(f"{kid} {what} on the QPSK link's shape ({steps} steps, one "
            f"stream): {err[kid]:.2e} of max|y| from its plain version; "
            f"kernel {ms[kid]:.4f} ms = {ms[kid] * 1e6 / steps:.1f} ns a step; "
            f"bound {bounds[kid][0]:.5f} ms ({bounds[kid][1]}); serial floor "
            f"{floor_ms:.4f} ms, {100 * floor_ms / ms[kid]:.1f}% of it; plain "
            f"{plain[kid]:.0f} ms on the CPU [{card}]")
        require(err[kid] <= LOOP_TOL, f"{kid} on the link's shape: {err[kid]}")
    log(f"S1 decisions flipped against its plain version: {flips}")
    require(flips == 0, f"S1 on the link's shape: {flips} decisions flipped")
    return {"ms": ms, "plain": plain, "err": err, "bounds": bounds}


# FP32 operations a step, for the bounds (the least work of the function):
# S1 a sincos (~20), the rotation 6, the detector 3, the clamps and updates
# 10, the wrap 4 and its divide; S2 interpolation 6, slicer 2, the error 10,
# omega and the step 10
COSTAS_OPS = 20 + 6 + 3 + 10 + 5
MM_OPS = 6 + 2 + 10 + 10


def phase_qpsk_link(torch, card: str) -> dict:
    """52. The QPSK link at full width in graph mode: qpsk_tx on the card,
    the channel, qpsk_receiver (AGC, 44-tap RRC matched filter, S2 at sps 4,
    S1 at loop_bw 0.06, decisions, diff decoder) over 4 batches of 2^20
    samples: symbols equal to the sent ones from symbol 2000 at the lag in
    every batch but at the 36 where the reference's receiver errs on this
    stream (QPSK_REF_ERRORS), S1 and S2 launched; graph mode bit-equal to
    the loop and to batches of 2^18; the step's two-point time, loop time
    and profile."""
    from newsched_tpu_torch import bench
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.models import qpsk_receiver
    from newsched_tpu_torch.ops.cuda import loops as kloops
    from newsched_tpu_torch.runtime.graph import Flowgraph

    syms, rx = qpsk_stream(torch)
    zero_launches()
    fg, b = qpsk_receiver(rx[:QPSK_BATCHES * QPSK_BATCH], sps=QPSK_SPS,
                          batch_size=QPSK_BATCH)
    r = fg.run(device="cuda")
    require(r._chunk is not None or QPSK_BATCHES < 2, "QPSK: no graph mode")
    launches = {"costas_loop": kloops.costas_loop.launches,
                "clock_recovery_mm": kloops.clock_recovery_mm.launches}
    got = b["sink"].data()
    log(f"QPSK link, {QPSK_BATCHES} batches of {QPSK_BATCH} samples in graph "
        f"mode: launches {launches}")
    require(all(v > 0 for v in launches.values()),
            "QPSK link: S1 or S2 never launched")
    qpsk_check(got, syms[:len(got)], "QPSK link, graph mode")

    def build(batch):
        def f(nb):
            return qpsk_receiver(rx[:nb * batch], sps=QPSK_SPS,
                                 batch_size=batch)
        return f

    loop_out, _ = graph_vs_loop(build(QPSK_BATCH // 4), "QPSK link at 2^18",
                                ["costas_loop.launches",
                                 "clock_recovery_mm.launches"])
    small = loop_out[:len(got)]
    require(np.array_equal(small, got[:len(small)]),
            "QPSK link: batches of 2^18 differ from batches of 2^20")
    log(f"QPSK link: batches of 2^18 ({len(small)} symbols) bit-equal to "
        f"batches of 2^20")

    def timed():
        src = general.vector_source(rx[:QPSK_BATCH], repeat=True)
        _, blk = qpsk_receiver(source=src, sps=QPSK_SPS, batch_size=QPSK_BATCH)
        g = Flowgraph("qpsk_receiver timed", batch_size=QPSK_BATCH)
        chain = [blk[k] for k in ("source", "agc", "mf", "timing", "carrier",
                                  "decoder", "diff")]
        for a, b_ in zip(chain, chain[1:] + [general.null_sink(dtype="ri32")]):
            g.connect(a, 0, b_, 0)
        return g

    sps = bench.timed_two_point(bench.graph_run(timed(), "cuda"),
                                "graph mode QPSK link", QPSK_BATCH, n_best=3,
                                k1=2, k2=6)
    step = QPSK_BATCH / sps * 1e3
    from newsched_tpu_torch.runtime.runner import Runner

    g = timed()
    g.validate()
    runner = Runner(g, batch_size=g.batch_size, device="cuda")
    params, box = runner.init_params(), {"s": runner.init_states()}

    def one():
        box["s"], _ = runner.cfg.step(box["s"], params)

    loop = median_ms(one, reps=3, inner=2, warmup=1)
    dev_ms = profile_steps(torch, one, "QPSK link", n=3)
    syms_per_s = QPSK_BATCH / QPSK_SPS / step * 1e3
    log(f"cell QPSK link: graph mode {step:.4f} ms a batch of {QPSK_BATCH} "
        f"samples = {QPSK_BATCH / step / 1e3:.2f} Msamples/s = "
        f"{syms_per_s / 1e6:.3f} Msymbols/s on one stream; loop {loop:.4f} ms;"
        f" device {dev_ms:.4f} ms a step; busy {100 * dev_ms / step:.0f}% "
        f"[{card}]")
    return {"launches": launches, "step": step, "loop": loop, "dev": dev_ms}


def bpsk_awgn(noise: np.ndarray):
    """The FEC link's channel as a block: ri16 coded bits -> rf32 LLRs
    2b - 1 + noise, the noise a seeded stream held on the device and read
    at the block's own position, modulo its length (a captured step replays
    it)."""
    import torch

    from newsched_tpu_torch.runtime.block import SyncBlock

    class bpsk_awgn(SyncBlock):
        def __init__(self):
            super().__init__()
            self.add_input("in", "ri16")
            self.add_output("out", "rf32")

        def init_state(self, nin, nout, device):
            return {"noise": torch.as_tensor(noise, device=device),
                    "pos": torch.zeros((), dtype=torch.int64, device=device)}

        def work(self, state, ins, params, nout):
            n = len(noise)
            idx = (state["pos"] + torch.arange(nout, device=ins["in"].device)) % n
            llr = 2.0 * ins["in"].to(torch.float32) - 1.0 + state["noise"][idx]
            return {**state, "pos": (state["pos"] + nout) % n}, {"out": llr}

    return bpsk_awgn()


def fec_link(bits: np.ndarray, noise: np.ndarray, batch_frames: int = FEC_FRAMES,
             sink: str = "vector", frame: int = FEC_FRAME, K: int = FEC_K,
             polys=(0o171, 0o133)):
    from newsched_tpu_torch.blocks import fec, general
    from newsched_tpu_torch.runtime.graph import Flowgraph

    fg = Flowgraph("fec link", batch_size=batch_frames * frame)
    snk = (general.vector_sink(dtype="ri16") if sink == "vector"
           else general.null_sink(dtype="ri16"))
    chain = [general.vector_source(bits, dtype="ri16",
                                   repeat=sink != "vector"),
             fec.cc_encoder(frame_bits=frame, polys=polys, K=K),
             bpsk_awgn(noise),
             fec.cc_decoder(frame_bits=frame, polys=polys, K=K), snk]
    for a, b in zip(chain, chain[1:]):
        fg.connect(a, 0, b, 0)
    return fg, snk


def phase_fec_link(torch, kfec, card: str) -> dict:
    """53. The FEC link in graph mode: cc_encoder (512-bit frames, K = 7,
    171/133) -> BPSK +-1 + AWGN -> LLR -> cc_decoder (S3), 4 batches of 1024
    frames: the decoded bits bit-equal to S3's plain version on the same
    LLRs and error-free at 7 dB (sigma 0.447); at the reference's own
    sigma 0.65 a decoded BER under a fifth of the raw; S3 launched; the
    step's two-point time."""
    from newsched_tpu_torch import bench
    from newsched_tpu_torch.ops import fec

    n_frames = FEC_BATCHES * FEC_FRAMES
    coded_per_frame = (FEC_FRAME + FEC_K - 1) * 2
    rng = np.random.default_rng(53)
    bits = rng.integers(0, 2, n_frames * FEC_FRAME).astype(np.int16)
    coded = fec.conv_encode(torch.from_numpy(bits.reshape(n_frames, -1))
                            .to(torch.int32)).numpy()
    tabs = fec.viterbi_tables((0o171, 0o133), FEC_K, "cuda")
    out = {}
    for sigma in (FEC_SIGMA_7DB, FEC_SIGMA_REF):
        noise = (sigma * rng.standard_normal(n_frames * coded_per_frame)
                 ).astype(np.float32)
        zero_launches()
        fg, snk = fec_link(bits, noise)
        r = fg.run(device="cuda")
        require(r._chunk is not None, "FEC link: no graph mode")
        launches = kfec.viterbi_frames.launches
        got = snk.data().astype(np.int32)
        llr = (2.0 * coded.reshape(-1).astype(np.float32) - 1.0 + noise)
        ref = np.concatenate([kfec.viterbi_frames_plain(
            torch.from_numpy(part).cuda().reshape(FEC_FRAMES, -1, 2), tabs,
            True, FEC_FRAME).cpu().numpy().reshape(-1)
            for part in np.split(llr, FEC_BATCHES)])
        errors = int((got != bits).sum())
        raw = int(((llr > 0) != (coded.reshape(-1) > 0)).sum())
        ber, raw_ber = errors / bits.size, raw / coded.size
        log(f"FEC link at sigma {sigma} ({10 * np.log10(1 / sigma ** 2):.2f} dB "
            f"Eb/N0), {FEC_BATCHES} batches of {FEC_FRAMES} frames in graph "
            f"mode: bit-equal to S3's plain version: {np.array_equal(got, ref)};"
            f" {errors} bit errors in {bits.size} (BER {ber:.2e}), raw BER "
            f"{raw_ber:.2e}; S3 launched {launches} times")
        require(np.array_equal(got, ref), f"FEC link sigma {sigma}: differs "
                "from S3's plain version")
        require(launches > 0, "FEC link: S3 never launched")
        if sigma == FEC_SIGMA_7DB:
            require(errors == 0, f"FEC link at 7 dB: {errors} bit errors")
        else:
            require(raw_ber > 0.02 and ber < raw_ber / 5,
                    f"FEC link at sigma {sigma}: BER {ber} against raw {raw_ber}")
        out[sigma] = {"launches": launches, "ber": ber, "raw_ber": raw_ber}
    fg, _ = fec_link(bits[:FEC_FRAMES * FEC_FRAME], noise[:FEC_FRAMES
                                                          * coded_per_frame],
                     sink="null")
    sps = bench.timed_two_point(bench.graph_run(fg, "cuda"),
                                "graph mode FEC link", FEC_FRAMES * FEC_FRAME,
                                n_best=3, k1=8, k2=32)
    step = FEC_FRAMES * FEC_FRAME / sps * 1e3
    log(f"cell FEC link: graph mode {step:.4f} ms a batch of {FEC_FRAMES} "
        f"frames = {sps / 1e6:.2f} Mbit/s decoded (with the block-a-frame S3: "
        f"{S3_BLOCK['link ms']} ms) [{card}]")
    out["step"] = step
    return out


# -- the host boundary: config #2 fed from a file and over TCP ---------------

IO_BATCHES = 16            # probes/ingest.py's 256 MB file: 16 batches
TCP_BATCHES = 4            # batches the TCP loopback carries (64 MB)
IO_TIME_RUNS = 3           # timed file-fed runs a form (the median kept)
IO_GATE_BATCHES = 2        # batches of a file-fed output gated on the golden


def io_file() -> str:
    """probes/ingest.py's file: FILE_MB MB of seeded random cf32 (x 0.5),
    under build/ingest/, whose batches all differ (a stale staging buffer
    would show)."""
    from newsched_tpu_torch.probes import ingest

    return ingest.cf32_file(ingest.FILE_MB * 2 ** 20 // 8)


def phase_ingest(path: str, card: str) -> list:
    """54. The ingest probe's three stages over the file (page cache warm):
    the ring alone, with the pinned staging, on to the card with a checksum
    there; the ring carried every byte, the card's checksum is the
    host's."""
    import os

    from newsched_tpu_torch.probes import ingest

    recs = ingest.ingest_stages(path, "cuda")
    size = os.path.getsize(path)
    for r in recs:
        log(f"ingest stage {r['probe']}: {r['MBps']:.1f} MB/s = "
            f"{r['Msps_cf32']:.1f} Msamples/s of cf32 (passes "
            f"{', '.join(f'{v:.1f}' for v in r['runs_MBps'])} MB/s; target "
            f"{r['target_MBps']} MB/s), {r['file_MB']:.0f} MB in batches of "
            f"{r['batch']} [{card}]")
        require(r["ring_bytes"] == size, f"{r['probe']}: the ring carried "
                f"{r['ring_bytes']} of {size} bytes")
    dev = recs[-1]
    log(f"ingest checksum on the card {dev['checksum']!r}, on the host "
        f"{dev['checksum_host']!r}")
    require(abs(dev["checksum"] - dev["checksum_host"])
            <= 1e-6 + 1e-9 * abs(dev["checksum_host"]),
            "ingest: the card's checksum is not the file's")
    return recs


def file_fed(path: str, fused: bool, n_batches: int, sink, **kw):
    """Config #2 (``fused``, or staged) reading ``path`` through
    file_source(use_native=True); returns (graph, blocks, source)."""
    from newsched_tpu_torch.blocks import fileio

    src = fileio.file_source(path, use_native=True)
    fg, blks = flowgraph(src, n_batches, sink=sink, fused=fused, **kw)
    return fg, blks, src


def phase_file_fed(torch, fm_chain, channelizer, path: str,
                   device: str = "cuda") -> dict:
    """55-56. Config #2 at full width, fused (K3) and staged (K1), over
    IO_BATCHES batches of the file: from memory (vector_source of the
    file's samples, graph mode) into a vector_sink, and from the file
    (file_source through the native ring, the loop) into file_sink. The
    file-fed run is counted (counts zeroed just before it), never captured,
    and its ring carried the whole file; file_sink's bytes are the
    memory-fed graph's output, bit for bit; their first IO_GATE_BATCHES
    batches pass the golden's gate."""
    import os

    from newsched_tpu_torch.blocks import general, fileio
    from newsched_tpu_torch.probes import ingest
    from newsched_tpu_torch.testing import planes_rows

    x = ingest.cf32_items(path, 0, IO_BATCHES * BATCH)
    require(len(x) == IO_BATCHES * BATCH, "the ingest file is short")
    rows = planes_rows(x[:IO_GATE_BATCHES * BATCH], M)
    kernel = {"fused": (fm_chain.fm_chain_step_planes, "K3"),
              "staged": (channelizer.arm_fold_dft, "K1")}
    out = {"launches": {}, "mem": {}}
    for form, fused in (("fused", True), ("staged", False)):
        fg, blks = flowgraph(general.vector_source(x), IO_BATCHES, fused=fused)
        r = fg.run(device=device)
        require(device != "cuda" or (r._chunk is not None
                                     and r._chunk.graph is not None),
                f"memory-fed {form}: no graph mode")
        mem = out["mem"][form] = blks["sink"].data()
        dst = os.path.join(ingest.DATA_DIR, f"config2_{form}.f32")
        fg, blks, src = file_fed(path, fused, IO_BATCHES,
                                 fileio.file_sink(dst, dtype="rf32",
                                                  vlen=(M,)))
        zero_launches()
        r = fg.run(device=device)
        fn, kid = kernel[form]
        n = out["launches"][kid] = fn.launches
        counts = {k: v for k, v in launch_counts().items() if v}
        got = np.fromfile(dst, np.float32).reshape(-1, M)
        same = got.shape == mem.shape and got.tobytes() == mem.tobytes()
        log(f"file-fed {form} config #2, {IO_BATCHES} batches: loop mode "
            f"(graph mode refused: {not r._can_graph()}, no chunk: "
            f"{r._chunk is None}); the ring carried {src.ring_reads} bytes; "
            f"file_sink's {got.shape} bit-equal to the memory-fed graph's "
            f"output: {same}; launches {counts}")
        require(r._chunk is None and not r._can_graph(),
                f"file-fed {form}: the runner captured a host-I/O graph")
        require(src.ring_reads == 8 * IO_BATCHES * BATCH,
                f"file-fed {form}: the ring carried {src.ring_reads} bytes")
        require(same, f"file-fed {form}: file_sink's bytes differ from the "
                "memory-fed graph's output")
        require(n > 0, f"file-fed {form}: {kid} was never launched")
        gate(rows, got[:IO_GATE_BATCHES * N_AUD], f"file-fed {form}",
             "file", SNR_GATE_DB if fused else STAGED_GATE_DB)
    return out


def phase_tcp(torch, fm_chain, path: str, mem_fused: np.ndarray,
              device: str = "cuda") -> int:
    """57. A TCP loopback: a thread serves TCP_BATCHES batches of the file
    into tcp_source (the ring's fd pump) -> fused config #2 -> tcp_sink
    (the ring's drain) -> a reading thread: the bytes read are the
    memory-fed graph's first batches, bit for bit; the ring carried every
    byte; K3 counted. Every thread joined with a timeout."""
    import socket
    import threading

    from newsched_tpu_torch.blocks import network

    data = np.fromfile(path, np.uint8, count=8 * TCP_BATCHES * BATCH)

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    port_in = free_port()
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    listener.settimeout(120)
    received, errors = bytearray(), []

    def serve():
        try:
            deadline = time.monotonic() + 60
            while True:
                try:
                    s = socket.create_connection(("127.0.0.1", port_in), 10)
                    break
                except ConnectionRefusedError:
                    require(time.monotonic() < deadline, "tcp_source never "
                            "listened")
                    time.sleep(0.05)
            with s:
                s.sendall(data.tobytes())
        except Exception as e:  # raised again below
            errors.append(e)

    def read():
        try:
            conn, _ = listener.accept()
            with conn:
                conn.settimeout(120)
                while chunk := conn.recv(1 << 20):
                    received.extend(chunk)
        except Exception as e:  # raised again below
            errors.append(e)

    threads = [threading.Thread(target=f, daemon=True) for f in (serve, read)]
    for t in threads:
        t.start()
    src = network.tcp_source(port_in, mode="server", use_native=True,
                             timeout_s=60)
    snk = network.tcp_sink(listener.getsockname()[1], mode="client",
                           dtype="rf32", vlen=(M,), use_native=True)
    fg, _ = flowgraph(src, TCP_BATCHES, sink=snk)
    zero_launches()
    r = fg.run(device=device)
    launches = fm_chain.fm_chain_step_planes.launches
    for t in threads:
        t.join(timeout=120)
    listener.close()
    require(not any(t.is_alive() for t in threads), "TCP loopback: a thread "
            "did not finish")
    if errors:
        raise errors[0]
    got = np.frombuffer(bytes(received), np.float32).reshape(-1, M)
    want = mem_fused[:TCP_BATCHES * N_AUD]
    same = got.shape == want.shape and got.tobytes() == want.tobytes()
    log(f"TCP loopback, fused config #2, {TCP_BATCHES} batches: "
        f"{len(data)} bytes in (the ring carried {src.ring_reads}), "
        f"{len(received)} bytes out, bit-equal to the memory-fed graph: "
        f"{same}; loop mode: {r._chunk is None}; K3 launched {launches}")
    require(src.ring_reads == len(data), "TCP loopback: the ring did not "
            "carry the stream")
    require(same, "TCP loopback: the output differs from the memory-fed graph")
    require(r._chunk is None, "TCP loopback: a host-I/O graph was captured")
    require(launches > 0, "TCP loopback: K3 never launched")
    return launches


def busy_run(torch, fn) -> tuple[float, float, list]:
    """fn() traced by torch.profiler: its host seconds, the device time of
    its kernels and copies in ms, and the largest of them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0), reverse=True)
    return wall, sum(r[0] for r in rows), rows[:6]


def phase_file_fed_times(torch, path: str, card: str,
                         graph_times: dict) -> dict:
    """58. The file-fed config #2, fused and staged, in loop mode (the
    runner's, file_source -> ... -> file_sink over the whole file, page
    cache warm): ms a batch (the median of IO_TIME_RUNS runs' host time
    over IO_BATCHES) and Msamples/s; the card's busy share in one traced
    run; beside the same graph fed from memory in graph mode (the bench's
    two-point fit) and phase 34's cells."""
    import os

    from newsched_tpu_torch import bench
    from newsched_tpu_torch.blocks import general, fileio
    from newsched_tpu_torch.probes import ingest

    x1 = ingest.cf32_items(path, 0, BATCH)
    out = {}
    for form, fused, cell in (("fused", True, "replay"),
                              ("staged", False, "staged")):
        dst = os.path.join(ingest.DATA_DIR, f"config2_{form}_timed.f32")

        def run():
            fg, _, _ = file_fed(path, fused, IO_BATCHES,
                                fileio.file_sink(dst, dtype="rf32", vlen=(M,)))
            fg.run(device="cuda")

        run()  # warm: kernels loaded, plans made, pages cached
        walls = []
        for _ in range(IO_TIME_RUNS):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        ms = float(np.median(walls)) / IO_BATCHES * 1e3
        wall, dev_ms, top = busy_run(torch, run)
        fg, _ = flowgraph(general.vector_source(x1, repeat=True), None,
                          sink="null", fused=fused)
        sps = bench.timed_two_point(bench.graph_run(fg, "cuda"),
                                    f"graph mode memory-fed cf32 {form}",
                                    BATCH, n_best=3, k1=GRAPH_K[0],
                                    k2=GRAPH_K[1])
        mem_ms = BATCH / sps * 1e3
        busy = dev_ms / (wall * 1e3)
        out[form] = {"ms": ms, "msps": BATCH / ms / 1e3, "busy": busy,
                     "mem_ms": mem_ms, "runs_ms": [w / IO_BATCHES * 1e3
                                                   for w in walls]}
        log(f"cell #2 {form} file-fed (not a cell): loop mode {ms:.4f} ms a "
            f"batch = {BATCH / ms / 1e3:.1f} Msamples/s (runs "
            f"{', '.join(f'{v:.4f}' for v in out[form]['runs_ms'])} ms); "
            f"traced run {wall * 1e3 / IO_BATCHES:.4f} ms a batch, device "
            f"{dev_ms / IO_BATCHES:.4f} ms a batch, busy {100 * busy:.1f}%; "
            f"memory-fed cf32 graph mode {mem_ms:.4f} ms "
            f"({BATCH / mem_ms / 1e3:.1f} Msamples/s); phase 34's {cell} "
            f"cell {graph_times[cell]:.4f} ms [{card}]")
        for d_ms, count, key in top:
            log(f"  {d_ms / IO_BATCHES:.4f} ms a batch x{count / IO_BATCHES:g}"
                f" {key[:100]}")
    return out


# -- partitions: config #2 across an edge, config #1 in a child, examples ----

PART_BATCHES = 16          # config #2 batches across the partition edge
PART_TIME_RUNS = 3         # timed partitioned runs (the median kept)
RADIO_BATCHES = 64         # config #1 batches the child partition sends
RADIO_FC2 = 290e3          # the retune's centre (the reference example's)
RADIO_BLOCK = "wbfm_rcv_fused_0"   # the child's one fused receiver
CHILD_S = 300              # the longest the child may take
RADIO_HWM = 2              # batches queued at each end of the radio edge
TRANSPORT_MSGS = 32        # messages of phase 59's transport probe


def free_tcp_address() -> str:
    """tcp://127.0.0.1 at a port the OS picks."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"tcp://127.0.0.1:{port}"


def partitioned_noise(addr: str):
    """Config #2's fused noise graph (K4 -> K3) split into "dsp" (the
    source, the chain and the head) and "tail" (the sink) at ``addr``:
    (Runtime, the sink). The tail's batch is one batch of audio rows."""
    from newsched_tpu_torch.runtime.distributed import (Runtime,
                                                        partition_flowgraph)

    fg, blks = flowgraph(None, PART_BATCHES)
    tail = [blks["sink"]]
    dsp = [b for b in fg.blocks if b is not blks["sink"]]
    head = next(e.src for e in fg.edges if e.dst is blks["sink"])
    parts = partition_flowgraph(fg, {"dsp": dsp, "tail": tail},
                                addresses={(head.name, "out"): addr})
    parts["tail"].batch_size = N_AUD
    return Runtime(parts, total_items={"tail": PART_BATCHES * N_AUD},
                   device="cuda"), blks["sink"]


def transport_ms(nbytes: int) -> float:
    """ms a message of ``nbytes`` through the port's ZMTP over TCP
    loopback, PUSH to PULL in this process (median of TRANSPORT_MSGS
    messages timed one by one, each sent when the last has arrived)."""
    from newsched_tpu_torch.io import zmtp

    addr = free_tcp_address()
    tx, rx = zmtp.Socket(zmtp.PUSH), zmtp.Socket(zmtp.PULL)
    rx.setsockopt(zmtp.RCVTIMEO, 60_000)
    tx.bind(addr)
    rx.connect(addr)
    msg = bytes(nbytes)
    times = []
    try:
        for _ in range(TRANSPORT_MSGS + 2):
            t0 = time.perf_counter()
            tx.send(msg)
            got = rx.recv()
            times.append(time.perf_counter() - t0)
            require(len(got) == nbytes, "transport probe: short message")
    finally:
        tx.close(0)
        rx.close(0)
    return float(np.median(times[2:])) * 1e3


def codec_ms(batch: np.ndarray) -> tuple[float, float]:
    """ms of blocks/zmq.py's encode and decode of ``batch`` on the host
    (the median of TRANSPORT_MSGS calls each)."""
    from newsched_tpu_torch.blocks import zmq as zb

    def med(fn):
        times = []
        for _ in range(TRANSPORT_MSGS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    msg = zb._encode_batch(batch)
    return med(lambda: zb._encode_batch(batch)), med(lambda: zb._decode_batch(msg))


def phase_partitioned(torch, fm_chain, noise, card: str) -> dict:
    """59. Config #2 fused noise (K4 -> K3) at full width split across a
    partition edge in this process: Runtime.run() of "dsp" and "tail" on
    two threads, about 1 MB of audio a batch through the port's ZMTP over
    TCP loopback, counted; the sink's array bit-equal to the unpartitioned
    graph's over PART_BATCHES batches. Then its ms a batch (the median of
    PART_TIME_RUNS runs) and the card's busy share in a traced run, beside
    the same graph unpartitioned in the runner's loop on the same host
    clock (``unpartitioned_loop``), its graph-mode device step and the
    transport alone."""
    import os

    from newsched_tpu_torch.blocks import fileio

    fg, blks = flowgraph(None, PART_BATCHES)
    fg.run(device="cuda")
    want = blks["sink"].data()
    rt, snk = partitioned_noise(free_tcp_address())
    zero_launches()
    rt.run()
    k3, k4 = fm_chain.fm_chain_step_planes.launches, noise.gaussian_rows.launches
    got = snk.data()
    same = got.shape == want.shape and got.tobytes() == want.tobytes()
    log(f"partitioned #2 fused noise, {PART_BATCHES} batches over "
        f"{rt.partitions['tail'].blocks[0].address}: {got.shape} bit-equal to "
        f"the unpartitioned graph: {same}; K4 launched {k4}, K3 {k3}")
    require(same, "partitioned #2 fused noise differs from the unpartitioned "
            "graph")
    require(k3 == PART_BATCHES and k4 == PART_BATCHES,
            "partitioned #2 fused noise: K3 or K4 not once a batch")
    gate(noise_rows(torch, noise, 2), got[:2 * N_AUD],
         "partitioned #2 fused noise", "noise", n_batches=2)
    walls, steady = [], []
    for _ in range(PART_TIME_RUNS):
        rt, _ = partitioned_noise(free_tcp_address())
        edge = rt.partitions["tail"].blocks[0]
        t0 = time.perf_counter()
        rt.start()
        require(edge.first_batch.wait(120), "partitioned: no first batch")
        t1 = time.perf_counter()
        rt.wait()
        t2 = time.perf_counter()
        walls.append((t2 - t0) / PART_BATCHES * 1e3)
        steady.append((t2 - t1) / (PART_BATCHES - 1) * 1e3)
    rt, _ = partitioned_noise(free_tcp_address())
    wall, dev_ms, top = busy_run(torch, rt.run)
    ms, ms_all = float(np.median(steady)), float(np.median(walls))
    un = unpartitioned_loop(torch, lambda: fileio.file_sink(
        os.devnull, dtype="rf32", vlen=(M,)))
    fg, _ = flowgraph(None, None, sink="null")
    step = fg_step_rate(torch, fg, "#2 fused noise, unpartitioned", card,
                        BATCH, profile=False)
    msg = int(got[:N_AUD].nbytes)
    tr = transport_ms(msg)
    enc, dec = codec_ms(got[:N_AUD])
    busy = dev_ms / (wall * 1e3)
    log(f"partitioned #2 fused noise (not a cell): {ms:.4f} ms a batch "
        f"after the first (runs {', '.join(f'{v:.4f}' for v in steady)}) = "
        f"{BATCH / ms / 1e3:.1f} Msamples/s; with the start-up "
        f"{ms_all:.4f} (runs {', '.join(f'{v:.4f}' for v in walls)}); "
        f"traced run {wall * 1e3 / PART_BATCHES:.4f} ms a batch, device "
        f"{dev_ms / PART_BATCHES:.4f} ms a batch, busy {100 * busy:.1f}% "
        f"(of the steady ms a batch {100 * dev_ms / PART_BATCHES / ms:.1f}%); "
        f"unpartitioned in the loop on the same clock {un['ms']:.4f} ms a "
        f"batch by the two-point fit (runs of {PART_BATCHES} and 1 batches: "
        f"{', '.join(f'{v:.4f}' for v in un['whole'])} / "
        f"{', '.join(f'{v:.4f}' for v in un['one'])} ms), with the start-up "
        f"{un['ms_all']:.4f}, busy {100 * un['busy']:.1f}% of a traced run; "
        f"its graph-mode device step {step:.4f} ms; the transport alone "
        f"{tr:.4f} ms a {msg}-byte message, the wire format's encode "
        f"{enc:.4f} ms and decode {dec:.4f} ms a batch [{card}]")
    for d_ms, count, key in top:
        log(f"  {d_ms / PART_BATCHES:.4f} ms a batch x{count / PART_BATCHES:g}"
            f" {key[:100]}")
    return {"K3": k3, "K4": k4, "ms": ms, "ms_all": ms_all, "busy": busy,
            "unpartitioned": un, "step": step,
            "transport": tr, "encode": enc, "decode": dec}


def unpartitioned_loop(torch, sink) -> dict:
    """Phase 59's graph unpartitioned, timed as the partitioned one is:
    host seconds of ``fg.run`` in the runner's loop (``sink()`` makes a
    host-I/O sink, so the graph is never captured; it collects as a
    vector_sink does),
    the median of PART_TIME_RUNS runs of PART_BATCHES batches and of one
    batch. ms: the two-point fit, a batch past the first; ms_all: a run of
    PART_BATCHES with its start-up, a batch; busy: device time over the
    host time of one traced run of PART_BATCHES."""

    def run(n: int) -> float:
        fg, _ = flowgraph(None, n, sink=sink())
        t0 = time.perf_counter()
        fg.run(device="cuda")
        return time.perf_counter() - t0

    run(PART_BATCHES)  # warm: kernels loaded, plans made
    whole, one = [], []
    for _ in range(PART_TIME_RUNS):
        whole.append(run(PART_BATCHES))
        one.append(run(1))
    w, o = float(np.median(whole)), float(np.median(one))
    wall, dev_ms, _ = busy_run(torch, lambda: run(PART_BATCHES))
    return {"ms": (w - o) / (PART_BATCHES - 1) * 1e3,
            "ms_all": w / PART_BATCHES * 1e3,
            "whole": [v / PART_BATCHES * 1e3 for v in whole],
            "one": [v * 1e3 for v in one], "busy": dev_ms / (wall * 1e3)}


class _Unpickled:
    """Unpickling this opens ``path`` for writing: what a forged control
    frame could make the server do, were it deserialized."""

    def __init__(self, path: str):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


def radio_child(data_addr: str, ctl_addr: str, key_hex: str) -> int:
    """Phase 60's child (``chip_smoke.py --radio DATA CTL KEY``): config
    #1 fused, K8 -> K10, at full width on the card, tuned to 200 kHz, its
    "radio" partition pushing RADIO_BATCHES batches of audio to
    ``data_addr`` under a keyed ControlServer at ``ctl_addr``. Loads the
    kernels the parent built and builds none. Prints one JSON line: whether
    it compiled, its launches of K8 and K10, its seconds."""
    import torch

    from newsched_tpu_torch import models
    from newsched_tpu_torch.blocks import analog
    from newsched_tpu_torch.ops.cuda import _build, sources, wbfm_chain
    from newsched_tpu_torch.runtime.distributed import (Runtime,
                                                        partition_flowgraph)

    if not torch.cuda.is_available():
        return 2
    t0 = time.monotonic()
    compiled = bool(_build.build().log)
    fg, blks = models.wbfm_receiver(
        fs=WB_FS, center_freq=WB_FC, quad_rate_decim=WB_D,
        audio_decim=(1, WB_RD), deviation=WB_DEV, fused=True,
        source=analog.sig_source(WB_FS, "complex", frequency=WB_TONE),
        batch_size=WB_BATCH, n_samples=RADIO_BATCHES * WB_NAUD * 64)
    require(blks["fused"].name == RADIO_BLOCK, "radio: another block name")
    head = next(e.src for e in fg.edges if e.dst is blks["sink"])
    radio = [b for b in fg.blocks if b is not blks["sink"]]
    parts = partition_flowgraph(fg, {"radio": radio, "audio": [blks["sink"]]},
                                addresses={(head.name, "out"): data_addr},
                                hwm=RADIO_HWM)
    sources.nco_planes.launches = wbfm_chain.wbfm_chain_step.launches = 0
    rt = Runtime({"radio": parts["radio"]}, control_addresses={"radio": ctl_addr},
                 control_auth_key=bytes.fromhex(key_hex), device="cuda")
    t_run = time.monotonic()
    rt.run()
    print(json.dumps({"compiled": compiled,
                      "K8": sources.nco_planes.launches,
                      "K10": wbfm_chain.wbfm_chain_step.launches,
                      "run_s": time.monotonic() - t_run,
                      "seconds": time.monotonic() - t0}), flush=True)
    return 0


def radio_local(fc: float) -> np.ndarray:
    """Config #1 fused as the child runs it, unpartitioned, here, tuned to
    ``fc``: (RADIO_BATCHES, audio a batch)."""
    from newsched_tpu_torch import models
    from newsched_tpu_torch.blocks import analog

    fg, blks = models.wbfm_receiver(
        fs=WB_FS, center_freq=fc, quad_rate_decim=WB_D,
        audio_decim=(1, WB_RD), deviation=WB_DEV, fused=True,
        source=analog.sig_source(WB_FS, "complex", frequency=WB_TONE),
        batch_size=WB_BATCH, n_samples=RADIO_BATCHES * WB_NAUD * 64)
    fg.run(device="cuda")
    return blks["sink"].data().reshape(RADIO_BATCHES, -1)


def control_refusals(ctl_addr: str, key: bytes, tmp: str) -> None:
    """Phase 60's checks of the keyed server before the retune: an unkeyed
    client refused; a frame that would open a file when unpickled refused
    and the file never made; a keyed request's exact bytes answered once
    (naming it) and refused when sent again."""
    import os
    import pickle

    from newsched_tpu_torch.io import zmtp
    from newsched_tpu_torch.runtime import control

    rogue = control.RuntimeClient(ctl_addr, timeout_ms=CHILD_S * 1000)
    try:
        rogue.ping()
        raise AssertionError("phase 60: the unkeyed client was served")
    except RuntimeError as e:
        log(f"unkeyed client refused: {e}")
    finally:
        rogue.close()
    raw = zmtp.Socket(zmtp.REQ)
    raw.setsockopt(zmtp.RCVTIMEO, CHILD_S * 1000)
    raw.setsockopt(zmtp.SNDTIMEO, CHILD_S * 1000)
    raw.connect(ctl_addr)
    canary = os.path.join(tmp, "unpickled")
    try:
        raw.send(pickle.dumps({"op": "ping", "x": _Unpickled(canary)}))
        rep = pickle.loads(raw.recv())
        require(not rep["ok"] and not os.path.exists(canary),
                "phase 60: an unkeyed frame was deserialized")
        session = os.urandom(16)
        frame = control.request_frame({"op": "get_param", "block": RADIO_BLOCK,
                                       "param": "center_freq"}, key, session, 1)
        raw.send(frame)
        sess, n, body = control._split_guard(control._unseal(raw.recv(), key))
        rep = pickle.loads(body)
        require((sess, n) == (session, 1) and rep["ok"]
                and float(rep["value"]) == WB_FC,
                f"phase 60: the keyed request was not answered: {rep}")
        raw.send(frame)
        rep = pickle.loads(raw.recv())
        require(not rep["ok"] and "replayed" in rep["error"],
                f"phase 60: a replayed frame was served: {rep}")
        log(f"keyed request answered (center_freq {float(WB_FC):.0f}); the "
            f"same bytes again refused: {rep['error']}")
    finally:
        raw.close(0)


def phase_retune(torch, sources, wbfm_chain, card: str) -> dict:
    """60. Config #1 fused across a process boundary, retuned: a child
    (subprocess, ``--radio``) runs the "radio" partition on the card, tuned
    to 200 kHz under a keyed ControlServer; this process runs pull_source
    -> head -> vector_sink on the card. Once it holds its first batch it
    sets center_freq to 290 kHz over the keyed socket (no sleep decides
    when). Checks: the refusals (control_refusals); one switched batch:
    every batch before it bit-equal to a local unpartitioned run at 200
    kHz, every batch after it bit-equal to one at 290 kHz; the child built
    no kernel. The edge holds RADIO_HWM batches at each end, so the child
    runs at most those and the TCP buffers' few ahead of what this process
    has taken: the retune lands well before the last batch whatever the
    two processes' timing."""
    import os
    import tempfile

    from newsched_tpu_torch import Flowgraph
    from newsched_tpu_torch.blocks import general, zmq as zb
    from newsched_tpu_torch.runtime.control import RuntimeClient

    before, after = radio_local(WB_FC), radio_local(RADIO_FC2)
    require(not np.array_equal(before[-1], after[-1]),
            "phase 60: the two tunings give the same audio")
    data_addr, ctl_addr = free_tcp_address(), free_tcp_address()
    key = os.urandom(32)
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--radio", data_addr,
         ctl_addr, key.hex()], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    n_aud = WB_NAUD * 64
    try:
        with tempfile.TemporaryDirectory() as tmp:
            control_refusals(ctl_addr, key, tmp)
        fg = Flowgraph(batch_size=n_aud)
        src = zb.pull_source(data_addr, bind=False, dtype="rf32",
                             timeout_s=CHILD_S, rcvhwm=RADIO_HWM)
        hd = general.head(RADIO_BATCHES * n_aud, dtype="rf32")
        snk = general.vector_sink(dtype="rf32")
        fg.connect(src, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        t0 = time.monotonic()
        runner = fg.start(device="cuda")
        ctl = RuntimeClient(ctl_addr, timeout_ms=CHILD_S * 1000, auth_key=key)
        try:
            require(src.first_batch.wait(CHILD_S), "phase 60: no first batch")
            t_first = time.monotonic()
            ctl.set_param(RADIO_BLOCK, "center_freq", RADIO_FC2)
            t_set = time.monotonic()
        finally:
            ctl.close()
        runner._thread.join(CHILD_S)
        t_end = time.monotonic()
        require(not runner._thread.is_alive(), "phase 60: the receiver hangs")
        fg.wait()
        out, err = child.communicate(timeout=CHILD_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate(timeout=60)
    require(child.returncode == 0, f"phase 60: the child failed "
            f"({child.returncode}):\n{err[-3000:]}")
    rep = json.loads(out.strip().splitlines()[-1])
    got = snk.data().reshape(RADIO_BATCHES, -1)
    on_before = [np.array_equal(g, b) for g, b in zip(got, before)]
    on_after = [np.array_equal(g, a) for g, a in zip(got, after)]
    k = on_before.index(False) if False in on_before else RADIO_BATCHES
    log(f"retuned #1 fused in a child, {RADIO_BATCHES} batches of {n_aud} "
        f"audio samples: bit-equal to the 200 kHz run through batch {k - 1}, "
        f"switched at batch {k} (equal to the 290 kHz run there: "
        f"{k < RADIO_BATCHES and on_after[k]}), to the 290 kHz run from "
        f"batch {k + 1} on: {all(on_after[k + 1:])}; first batch "
        f"{t_first - t0:.2f} s after start, set_param answered in "
        f"{(t_set - t_first) * 1e3:.2f} ms, the rest received at "
        f"{(t_end - t_first) / (RADIO_BATCHES - 1) * 1e3:.4f} ms a batch "
        f"(the child's run {rep['run_s'] / RADIO_BATCHES * 1e3:.4f} ms a "
        f"batch, start-up included); the child: {rep} [{card}]")
    require(0 < k < RADIO_BATCHES - 1, f"phase 60: the retune landed at "
            f"batch {k} of {RADIO_BATCHES}")
    require(all(on_before[:k]) and all(on_after[k + 1:]),
            "phase 60: a batch is neither the 200 kHz run's nor the 290 kHz "
            "run's")
    require(not rep["compiled"], "phase 60: the child built kernels")
    require(rep["K8"] == RADIO_BATCHES and rep["K10"] == RADIO_BATCHES,
            f"phase 60: the child's K8/K10 not once a batch: {rep}")
    return {"K8": rep["K8"], "K10": rep["K10"], "switch": k,
            "ms": (t_end - t_first) / (RADIO_BATCHES - 1) * 1e3}


EXAMPLES = ("channelizer", "fm_receiver", "live_flagship",
            "sharded_channelizer", "distributed_pipeline",
            "retune_live_receiver")


def phase_examples() -> dict:
    """61. The port's examples on the card, each its ``main("cuda")`` (each
    asserts what its twin in examples/ does); yaml_block needs PyYAML,
    which this machine lacks, and runs on the CPU only."""
    import importlib

    seconds = {}
    for name in EXAMPLES:
        t0 = time.monotonic()
        importlib.import_module(f"newsched_tpu_torch.examples.{name}").main("cuda")
        seconds[name] = time.monotonic() - t0
        log(f"example {name}: passed on the card in {seconds[name]:.1f} s")
    return seconds


DEFAULT_A = 193            # the model's own audio FIR at 100 MS/s, 64 channels
LONG_FIR_M = (64, 128, 512)  # chain_tile, chain_tile_stream, chain_tile_wide
LONG_FIR_ROWS = 4096       # planes rows a batch of phase 62's kernel checks
LONG_FIR_BATCHES = 4       # batches of phase 62's model runs


def phase_long_audio_fir(torch, fm_chain, noise) -> dict:
    """62. The chains with an audio FIR longer than their tile (ROADMAP
    F4): the model's own 193 taps (DEFAULT_A) against a tile of 128 rows.
    At M = 64, 128 and 512 (each of the three tile routines) K3 on two
    carried batches of an M-station FM band within K3_TOL of its plain
    version and bit-identical at tile 64; K5 from stream start bit-equal
    to K4 * amp -> K3; K6 over 4 shards in one launch bit-equal to K5.
    Then ``fm_channelizer(fused=True)`` with its default audio FIR at full
    width: the live model (K5) bit-equal to the fused noise model (K4 ->
    K3) over LONG_FIR_BATCHES batches, finite. Returns K3's worst error
    and the models' launches."""
    from newsched_tpu_torch import models
    from newsched_tpu_torch.blocks import vector_dsp
    from newsched_tpu_torch.ops import firdes
    from newsched_tpu_torch.testing import planes_rows

    n, worst = LONG_FIR_ROWS, 0.0
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    g0 = noise.group_tensor(0, "cuda")
    chan_rate = 100e6 / 64
    at = firdes.low_pass(1.0, chan_rate, 0.4 * chan_rate / DECIM,
                         0.1 * chan_rate / DECIM)
    require(len(at) == DEFAULT_A, f"phase 62: the default FIR has {len(at)} "
            f"taps, not {DEFAULT_A}")
    for m in LONG_FIR_M:
        W = 2 * m
        consts = vector_dsp.fm_channelizer_fused_planes(
            m, firdes.prototype_channelizer_taps(m, L), at,
            audio_decim=DECIM).consts("cuda")
        rows = torch.from_numpy(planes_rows(fm_band(2 * n * m, "cuda", m),
                                            m)).cuda()

        def zero():
            return (torch.zeros(16, W, **z), torch.zeros(1, W, **z),
                    torch.zeros(DEFAULT_A - 1, W, **z))

        def k3(step, **kw):
            halo, prev, tail = zero()
            outs = []
            for b in range(2):
                vb = rows[b * n:(b + 1) * n]
                aud, prev, tail = step(vb, halo, prev, tail, consts, DECIM,
                                       DEMOD_GAIN, **kw)
                outs += [aud, prev, tail]
                halo = vb[-16:].contiguous()
            return outs

        got = k3(fm_chain.fm_chain_step_planes)
        err = max(float((g - r).abs().max()) for g, r in
                  zip(got, k3(fm_chain.fm_chain_step_planes_plain)))
        tiles = all(torch.equal(a, b) for a, b in
                    zip(got, k3(fm_chain.fm_chain_step_planes, tile=64)))
        k5 = fm_chain.fm_chain_gen_step(g0, amp, *zero(), consts, DECIM,
                                        DEMOD_GAIN, n)
        nrows = noise.gaussian_rows(g0, n_rows=n, width=W, seed=0,
                                    device="cuda", amp=amp)
        k4k3 = fm_chain.fm_chain_step_planes(nrows, *zero(), consts, DECIM,
                                             DEMOD_GAIN)
        k5_ok = all(torch.equal(a, b) for a, b in zip(k5[:3], k4k3))
        k6_ok = torch.equal(fm_chain.fm_chain_gen_warm_step(
            g0, amp, consts, DECIM, DEMOD_GAIN, n // 4, warm=K6_WARM, nd=4),
            k5[0])
        log(f"A={DEFAULT_A} at M={m} ({n} rows, tile 128): K3 {err:.3e} from "
            f"plain (tol {K3_TOL}), tile 64 bit-identical: {tiles}; K5 "
            f"bit-equal to K4 * amp -> K3: {k5_ok}; K6 over 4 shards "
            f"bit-equal to K5: {k6_ok}")
        require(err <= K3_TOL and tiles and k5_ok and k6_ok,
                f"A={DEFAULT_A} at M={m}: K3 {err:.3e} from plain, tiles "
                f"{tiles}, K5 {k5_ok}, K6 {k6_ok}")
        worst = max(worst, err)
    out = {}
    zero_launches()
    for source in ("live", None):
        fg, blks = models.fm_channelizer(
            nchans=M, taps_per_arm=L, fused=True, source=source,
            batch_size=BATCH, sink="vector",
            n_samples=LONG_FIR_BATCHES * N_AUD)
        require(len(blks["audio_taps"]) == DEFAULT_A,
                "phase 62: the model's FIR is not its default")
        fg.run(device="cuda")
        out[source] = blks["sink"].data()
    launches = {"K5": fm_chain.fm_chain_gen_step.launches,
                "K3": fm_chain.fm_chain_step_planes.launches,
                "K4": noise.gaussian_rows.launches}
    same = np.array_equal(out["live"], out[None])
    log(f"fm_channelizer(fused=True) with its default {DEFAULT_A}-tap audio "
        f"FIR, {LONG_FIR_BATCHES} batches of {BATCH}: live {out['live'].shape} "
        f"bit-equal to the fused noise model: {same}, finite: "
        f"{bool(np.isfinite(out['live']).all())}; launches {launches}")
    require(same and bool(np.isfinite(out["live"]).all())
            and out["live"].shape == (LONG_FIR_BATCHES * N_AUD, M),
            "phase 62: the default-FIR live model differs from the fused one")
    require(all(v >= 1 for v in launches.values()),
            f"phase 62: a kernel of the default-FIR models did not launch: "
            f"{launches}")
    return {"err": worst, "launches": launches}


def late_phases(which: list) -> int:
    """``chip_smoke.py --phases 59-62``: the build, then phases 59-62
    alone (the partitions, the examples and the long audio FIR), each
    checked as in the whole run; prints their numbers as one JSON line and
    no result line. The only group it takes is 59-62."""
    if which != ["59-62"]:
        print("chip_smoke.py: --phases takes 59-62", file=sys.stderr)
        return 2
    from newsched_tpu_torch.ops.cuda import (_build, fm_chain, noise, sources,
                                             wbfm_chain)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    _build.build()
    log(f"build: {time.monotonic() - t0:.1f} s (nvcc, sm_90a)")
    t59 = time.monotonic()
    part = phase_partitioned(torch, fm_chain, noise, card)
    radio = phase_retune(torch, sources, wbfm_chain, card)
    t61 = time.monotonic()
    phase_examples()
    t62 = time.monotonic()
    long_fir = phase_long_audio_fir(torch, fm_chain, noise)
    log(f"phases 59-62: {time.monotonic() - t59:.1f} s (59-60 "
        f"{t61 - t59:.1f}, 61 {t62 - t61:.1f}, 62 {time.monotonic() - t62:.1f})")
    print(json.dumps({"partitioned": part, "retune": radio,
                      "long_fir": long_fir, "card": card}), flush=True)
    return 0


# -- the least time of each kernel's work on the card ------------------------

PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s (published)
PEAK_FP32 = 67e12      # FP32 outside the tensor cores, operations/s


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    FP32 peak (the integer work of Philox is counted at the same rate, the
    nearest entry of the published table), in ms, and which one it is."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


ATAN_OPS = 2 * 9 + 10   # degree-9 polynomial in z^2 + reduction and quadrant
DEMOD_OPS = 6 + ATAN_OPS + 1        # conj product, atan2, gain
NCO_OPS = 2 + 2 + 5 + 2 * 2 * 5 + 1 + 4 + 2  # phase, turns, reduce, polys, select, amp
PHILOX_OPS = 10 * 10 + 14           # 10 rounds, Irwin-Hall sum and scale
# an overlap-save FFT convolution at 1024 points and 128 taps: a forward and
# an inverse FFT (2 x 5 N log2 N) and N complex products (6 N) per 897
# outputs, ~121 flops a complex output (K9 takes 256 points, 128 outputs a
# transform: ~172)
FIR_FFT_OPS = 121


def fir_fft_ops(ntaps: int) -> float:
    """Flops a complex output of an overlap-save FFT convolution with real
    taps at its most economical power-of-two length N: a forward and an
    inverse FFT (2 x 5 N log2 N) and N complex products (6 N) per N -
    ntaps + 1 outputs."""
    return min((10 * N * np.log2(N) + 6 * N) / (N - ntaps + 1)
               for N in (1 << k for k in range(8, 20)) if N > 2 * ntaps)


def chain_bounds(m: int, n: int, n6: int, nd: int = 1) -> dict:
    """(bound ms, bound_by) of K3, K5, K6 (at n6 rows, over nd shards, each
    generating the A + L - 1 rows before it) and K1 at m channels and n
    rows, as kernel_bounds counts them at the flagship's."""
    f4, W = 4, 2 * m
    fold = 2 * L * n * W
    fft = 5 * m * np.log2(m) * n
    audio = 2 * A * (n // DECIM) * m
    demod = DEMOD_OPS * n * m
    chain_out = ((n // DECIM) * m + (A - 1) * W + W) * f4
    r6 = n6 / n
    k6_ops = (fold + fft + demod + audio) * r6 \
        + PHILOX_OPS * (n6 + nd * (A + L - 1)) * W
    return {
        "K3": bound((n + L) * W * f4 + chain_out, fold + fft + demod + audio),
        "K5": bound(chain_out, fold + fft + demod + audio + PHILOX_OPS * n * W),
        "K6": bound((n6 // DECIM) * m * f4, k6_ops),
        "K1": bound((n + L - 1) * W * f4 + n * W * f4, fold + fft),
    }


def kernel_bounds() -> dict:
    """(bound ms, bound_by) of every kernel at the shapes this run gives it:
    each input read once and each output written once, and the least
    arithmetic of the function (multiply-adds count 2), not of the
    kernel's formulation: an M-point FFT a row (5 M log2 M flops), which
    the fused chains take and K1 does as a dense (2M x 2M) real DFT
    product, and for K10/K12 the
    staged order (rotate each input sample by the NCO, then a real-tap FIR)
    where the kernels filter with complex rotated taps, and for K9 an FFT
    convolution at its most economical length."""
    f4 = 4
    n, W = ROWS, 2 * M
    fold = 2 * L * n * W
    fft = 5 * M * int(np.log2(M)) * n
    audio = 2 * A * (n // DECIM) * M
    demod = DEMOD_OPS * n * M
    chain_out = ((n // DECIM) * M + (A - 1) * W + W) * f4
    # K6 over the 4 shards of a batch (the sharded live graph's one
    # launch): K5's work at its rows, and the A + L - 1 rows before each
    # shard that it generates for its junction; only the audio leaves
    k6_ops = (fold + fft + demod + audio) \
        + PHILOX_OPS * (n + 4 * (A + L - 1)) * W
    U = (WB_R // WB_D) * 64  # xlate outputs
    # real taps on complex samples (4 flops a tap), demod, real resampler
    wb_chain = 4 * 81 * U + DEMOD_OPS * U + 2 * 121 * WB_NAUD * 64
    rotate = (NCO_OPS + 6) * WB_BATCH  # NCO + a complex multiply a sample
    wide = chain_bounds(WIDE_M[0], WIDE_ROWS, WIDE_ROWS // 4)
    return {
        **{k + "w": v for k, v in wide.items()},
        # the partitioned instance's function: config #0 at 1024 taps
        "K9p": bound(FIR_R * 128 * f4, (NCO_OPS + fir_fft_ops(
            K9_LIVE_TAPS)) * FIR_BATCH),
        "K3": bound((n + L) * W * f4 + chain_out, fold + fft + demod + audio),
        "K4": bound(n * W * f4, PHILOX_OPS * n * W),
        "K1": bound((n + L - 1) * W * f4 + n * W * f4, fold + fft),
        "K7": bound((n + L - 1) * W * f4 + n * W * f4, fold),
        "K5": bound(chain_out, fold + fft + demod + audio + PHILOX_OPS * n * W),
        "K6": bound((n // DECIM) * M * f4, k6_ops),
        "K8": bound(2 * WB_BATCH * f4, NCO_OPS * WB_BATCH),
        "K11": bound(WB_R * 128 * f4, NCO_OPS * WB_R * 64),
        "K10": bound((WB_R + 568) * 128 * f4 + WB_NAUD * 128 * f4,
                     wb_chain + rotate),
        # the live tone, rotated, is one NCO at the offset frequency
        "K12": bound(WB_NAUD * 128 * f4, wb_chain + NCO_OPS * WB_BATCH),
        # the output alone; the NCO and an FFT convolution a sample
        "K9": bound(FIR_R * 128 * f4, (NCO_OPS + FIR_FFT_OPS) * FIR_BATCH),
        # K3's function
        "K3p": bound((n + L) * W * f4 + chain_out, fold + fft + demod + audio),
        # K2 alone at the demod's shape: y and x read, the angle written
        "K2": bound(3 * n * M * f4, ATAN_OPS * n * M),
    }


def graph_ms(fn, reps: int = REPS, inner: int = 10) -> float:
    """Device time of one call without the host's enqueue time: ``inner``
    calls captured once in a CUDA graph, the graph replayed under CUDA
    events (median of ``reps``), divided by ``inner``. Where the host takes
    longer to launch a call than the card to run it (the NCO kernels), an
    event time of back-to-back calls measures the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    return median_ms(g.replay, reps=reps, inner=1) / inner


def alternate(fns: dict, plain_reps: int = REPS) -> dict:
    """The time of each named call, twice: in the reverse of the given
    order, then in it, so each kernel and its plain version alternate.
    Kernels (and compositions of kernels) by graph_ms; the plain versions,
    named '... plain', by median_ms with ``plain_reps`` reps: their torch
    ops run as a caller runs them, host included."""
    names = list(fns)
    out: dict = {}
    for name in names[::-1] + names:
        if name.endswith(" plain"):
            ms = median_ms(fns[name], reps=plain_reps)
        else:
            ms = graph_ms(fns[name])
        out.setdefault(name, []).append(ms)
    return out


def main() -> int:
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.ops import nco as nco_mod
    from newsched_tpu_torch.ops.cuda import (_build, channelizer, fec as kfec,
                                             fir_source, fm_chain,
                                             loops as kloops, mathfns, noise,
                                             sources, wbfm_chain)
    from newsched_tpu_torch.probes import run as probes
    from newsched_tpu_torch.testing import planes_rows

    import torch  # after the port, so a copy without it fails before torch loads

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    # 1. device
    t_start = time.monotonic()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.monotonic()
    built = _build.build()
    log(f"build: {time.monotonic() - t0:.1f} s (nvcc, sm_90a)")
    kernel = "?"
    for line in built.log.splitlines():
        if "entry function" in line:
            kernel = kernel_name(line)
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: " + line.split(":", 1)[-1].strip())

    # 3-5. the kernels against their plain versions
    k4_err = phase_k4(torch, noise)
    phase_k2(torch, mathfns)
    k3_err = phase_k3(torch, fm_chain)

    # 6-8. the main path, counted
    rng = np.random.default_rng(0)
    x = ((rng.standard_normal(BATCH) + 1j * rng.standard_normal(BATCH))
         * 0.5).astype(np.complex64)
    rows = planes_rows(x, M)
    fm_chain.fm_chain_step_planes.launches = 0
    noise.gaussian_rows.launches = 0
    replay_out = phase_replay(rows)
    fused_out = phase_noise(torch, noise)
    launches = {"fm_chain": fm_chain.fm_chain_step_planes.launches,
                "noise": noise.gaussian_rows.launches}
    log(f"launches on the main path: fm_chain_step_planes "
        f"{launches['fm_chain']}, gaussian_rows {launches['noise']}")
    require(launches["fm_chain"] > 0 and launches["noise"] > 0,
            "a kernel of the main path was never launched")

    # 9. times
    H8 = fm_chain._round8(L - 1)
    consts = chain_consts()
    vb = torch.from_numpy(rows).cuda()
    z = dict(dtype=torch.float32, device="cuda")
    st = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    g0 = noise.group_tensor(0, "cuda")  # the sources' counter, on the card
    t = alternate({
        "K3 plain": lambda: fm_chain.fm_chain_step_planes_plain(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K3": lambda: fm_chain.fm_chain_step_planes(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K4 plain": lambda: noise.gaussian_rows_plain(
            g0, n_rows=ROWS, width=2 * M, seed=0, device="cuda"),
        "K4": lambda: noise.gaussian_rows(
            g0, n_rows=ROWS, width=2 * M, seed=0, device="cuda"),
    })
    k3_t256 = graph_ms(lambda: fm_chain.fm_chain_step_planes(
        vb, *st, consts, DECIM, DEMOD_GAIN, tile=256))
    log(f"K3 fm_chain_step_planes ({ROWS} x {2 * M} rows): kernel "
        f"{t['K3']} ms (tile 256: {k3_t256:.4f} ms), plain {t['K3 plain']} ms "
        f"[{card}]")
    log(f"K4 gaussian_rows ({ROWS} x {2 * M}): kernel {t['K4']} ms, "
        f"plain {t['K4 plain']} ms [{card}]")
    step_rate(torch, general.vector_source(rows, repeat=True), "replay", card)
    step_rate(torch, None, "noise source", card)

    # 10-14. the staged and live paths, each counted
    fold_err = phase_k1_k7(torch, channelizer)
    staged = phase_staged(torch, noise, channelizer)
    dec_launches = phase_decimator(torch, channelizer)
    k5_err, first_batch_d2 = phase_k5(torch, fm_chain, noise)
    live_launches = phase_live(torch, fm_chain, noise, fused_out,
                               first_batch_d2)

    # 15. times
    c2, w2, fft = fold_consts(torch, channelizer)
    v = commutator(torch, channelizer, x)
    amp = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    k5_rows = composed(noise.gaussian_rows, fm_chain.fm_chain_step_planes)
    k5_args = (g0, amp, *st, consts, DECIM, DEMOD_GAIN, ROWS)
    # K7 over 4 copies of its input, its outputs kept: 67 MB in and as
    # much out, past the 50 MB L2, as a stream's batches come
    vs = [v.clone() for _ in range(probes.ROT)]
    t.update(alternate({
        "K7 plain": lambda: channelizer.arm_fold_plain(v, c2, ROWS),
        "K7": probes.rotating(lambda i: (vs[i],), lambda vv:
                              channelizer.arm_fold(vv, c2, ROWS)),
        "K1 plain": lambda: channelizer.arm_fold_dft_plain(v, c2, w2, ROWS),
        "K1": lambda: channelizer.arm_fold_dft(v, c2, w2, ROWS, fft=fft),
        "K5 plain": lambda: fm_chain.fm_chain_gen_step_plain(*k5_args),
        "K4 -> K3": lambda: k5_rows(*k5_args, draws=3),
        "K5": lambda: fm_chain.fm_chain_gen_step(*k5_args),
    }, PLAIN_REPS))
    ms = {k: min(v_) for k, v_ in t.items()}
    for name, what in (("K7", "arm_fold"), ("K1", "arm_fold_dft"),
                       ("K5", "fm_chain_gen_step")):
        log(f"{name} {what} ({ROWS} x {2 * M} rows): kernel {t[name]} ms, "
            f"plain {t[name + ' plain']} ms [{card}]")
    log(f"K4 * amp -> K3 (what K5 fuses): {t['K4 -> K3']} ms [{card}]")
    step_rate(torch, None, "staged", card, fused=False)
    step_rate(torch, "live", "live", card)
    decimator_step(torch, card)
    # one PyTorch call computing K7's function: the depthwise correlation
    # of every lane with its L taps (cuDNN, FP32: TF32 is off above). Its
    # inputs transposed to (lanes, rows) and its weight are prepared here,
    # outside its timing: the call is timed alone, over the same 4 inputs
    vTs = [vv.T.contiguous()[None] for vv in vs]
    w7 = c2.T.contiguous()[:, None, :]

    def conv(x):
        return torch.nn.functional.conv1d(x, w7, groups=2 * M)

    lib = {"K7": graph_ms(probes.rotating(lambda i: (vTs[i],), conv))}
    geo = probes.fold_geometry(2 * M, L, ROWS)
    k7_one, conv_one = (graph_ms(lambda: channelizer.arm_fold(v, c2, ROWS)),
                        graph_ms(lambda: conv(vTs[0])))
    log(f"K7 over 4 rotating inputs and outputs {ms['K7']:.4f} ms, "
        f"{kernel_bounds()['K7'][0] / ms['K7']:.1%} of its bound; library call "
        f"conv1d(groups={2 * M}) {lib['K7']:.4f} ms; on one input K7 "
        f"{k7_one:.4f} ms, conv1d {conv_one:.4f} ms; K7's default run "
        f"{geo['run_rows']} rows a thread, {geo['registers']} registers, "
        f"{geo['blocks_per_sm']} blocks of {geo['threads']} threads an SM "
        f"[{card}]")

    # 16-20. config #1, the wideband-FM receiver, each path counted
    nco_err = phase_k8_k11(torch, sources)
    k10_err = phase_k10(torch, wbfm_chain)
    k12_err = phase_k12(torch, sources, wbfm_chain)
    wb = phase_wbfm_graphs(torch, sources, wbfm_chain)

    plan, wconsts, _, _ = wb_plan()
    # the stream state as the blocks keep it, on the card: host values would
    # be uploaded by each call, which no CUDA graph capture allows
    ph7 = nco_mod.phase_tensor(7, "cuda")
    dp = nco_mod.phase_tensor(nco_mod.freq_to_dphase(WB_TONE, WB_FS), "cuda")
    off = torch.zeros((), dtype=torch.bool, device="cuda")
    a8 = torch.tensor(0.8, dtype=torch.float32, device="cuda")
    xp = wbfm_chain.fold_planes(fm_signal(WB_BATCH, torch))
    carry = torch.zeros(plan.B8, 128, device="cuda")
    # K10 and K12 over 4 inputs and outputs (probes.rotating; K10's 4
    # batches, 67 MB, past the L2), as K7, P-prep and K2 are, and on one
    xps = [xp] + [wbfm_chain.fold_planes(fm_signal(WB_BATCH, torch) * (0.9 ** i))
                  for i in range(1, probes.ROT)]

    def k11_k10():
        wbfm_chain.wbfm_chain_step(sources.nco_folded(ph7, dp, a8, WB_R, "cuda"),
                                   carry, plan, wconsts)

    t.update(alternate({
        "K8 plain": lambda: sources.nco_planes_plain(ph7, dp, a8, WB_BATCH, "cuda"),
        "K8": lambda: sources.nco_planes(ph7, dp, a8, WB_BATCH, "cuda"),
        "K11 plain": lambda: sources.nco_folded_plain(ph7, dp, a8, WB_R, "cuda"),
        "K11": lambda: sources.nco_folded(ph7, dp, a8, WB_R, "cuda"),
        "K10 plain": lambda: wbfm_chain.wbfm_chain_step_plain(xp, carry, plan,
                                                              wconsts),
        "K10": probes.rotating(lambda i: (xps[i],), lambda x: wbfm_chain
                               .wbfm_chain_step(x, carry, plan, wconsts)),
        "K10 one": lambda: wbfm_chain.wbfm_chain_step(xp, carry, plan, wconsts),
        "K12 plain": lambda: wbfm_chain.wbfm_chain_live_step_plain(
            ph7, dp, a8, off, plan, wconsts, WB_R),
        "K11 -> K10": k11_k10,
        "K12": probes.rotating(lambda i: (), lambda: wbfm_chain
                               .wbfm_chain_live_step(ph7, dp, a8, off, plan,
                                                     wconsts, WB_R)),
        "K12 one": lambda: wbfm_chain.wbfm_chain_live_step(
            ph7, dp, a8, off, plan, wconsts, WB_R),
    }, PLAIN_REPS))
    ms = {k: min(v_) for k, v_ in t.items()}
    for name, what in (("K8", "nco_planes"), ("K11", "nco_folded"),
                       ("K10", "wbfm_chain_step"),
                       ("K12", "wbfm_chain_live_step")):
        one = (f" over 4 rotating inputs and outputs, {t[name + ' one']} ms "
               f"on one" if name + " one" in t else "")
        log(f"{name} {what}: kernel {t[name]} ms{one}, plain "
            f"{t[name + ' plain']} ms [{card}]")
    log(f"K11 -> K10 (what K12 fuses): {t['K11 -> K10']} ms [{card}]")
    for tile, gs in WB_GEOMS:
        k10_ms = graph_ms(lambda: wbfm_chain.wbfm_chain_step(
            xp, carry, plan, wconsts, tile=tile, seg_group=gs))
        k12_ms = graph_ms(lambda: wbfm_chain.wbfm_chain_live_step(
            ph7, dp, a8, off, plan, wconsts, WB_R, tile=tile, seg_group=gs))
        blocks = (WB_R // tile) * (64 // gs)
        extra = (plan.A + 1) / (tile // (WB_D * WB_RD) * WB_RD)
        smem = wbfm_chain._geometry(plan, WB_R, tile, gs).smem
        log(f"K10/K12 tile {tile} seg_group {gs}: {blocks} blocks, {smem} B "
            f"shared, junction +{100 * extra:.0f}% xlate outputs; K10 "
            f"{k10_ms:.4f} ms, K12 {k12_ms:.4f} ms [{card}]")
    for kind in ("staged", "fused", "folded", "live"):
        wb_step_rate(torch, kind, card)

    # 21-23. config #0, the FIR chain, and K3's pipelined form, each counted
    k9_err = phase_k9(torch, fir_source)
    fir = phase_fir_graphs(torch, sources, fir_source)
    k3p = phase_k3p(torch, fm_chain)

    # 24. times
    _, taps9 = fir_taps(torch)
    dp9 = nco_mod.phase_tensor(nco_mod.freq_to_dphase(FIR_FREQ, FIR_FS), "cuda")
    # the two-call form of K9: K11's tone, then every lane's FIR by one
    # grouped convolution (its look-back is zeros, not the previous
    # segment's samples; cuDNN in FP32, TF32 off above)
    w9 = taps9.taps.flip(0).repeat(128, 1)[:, None, :].contiguous()

    def k11_conv():
        x9 = sources.nco_folded(ph7, dp9, a8, FIR_R, "cuda")
        return torch.nn.functional.conv1d(x9.T[None], w9, groups=128,
                                          padding=FIR_NTAPS - 1)

    # K2 alone (inside K3, K3p, K5, K10, K12) at the demod's shape, beside
    # one PyTorch call computing atan2: each call takes the next of 4 (y, x)
    # pairs and keeps its output (probes.rotating; 101 MB in all, past the
    # 50 MB L2, as a stream's batches come), and once more on one input
    gen2 = torch.Generator(device="cuda").manual_seed(3)
    d2s = [torch.randn(2, ROWS, M, device="cuda", generator=gen2)
           for _ in range(probes.ROT)]
    d2 = d2s[0]

    def rot(fn):
        return probes.rotating(lambda i: (d2s[i][0], d2s[i][1]), fn)

    t.update(alternate({
        "K2 plain": rot(mathfns.atan2_plain),
        "K2 library": rot(torch.atan2),
        "K2": rot(mathfns.atan2),
    }))
    k2_one = {"K2": graph_ms(lambda: mathfns.atan2(d2[0], d2[1])),
              "torch.atan2": graph_ms(lambda: torch.atan2(d2[0], d2[1]))}
    k2_ms = min(t["K2"])
    log(f"K2 atan2 ({ROWS} x {M}) over 4 rotating inputs and outputs: kernel "
        f"{t['K2']} ms, {kernel_bounds()['K2'][0] / k2_ms:.1%} of its bound; "
        f"plain {t['K2 plain']} ms, torch.atan2 {t['K2 library']} ms; on one "
        f"input K2 {k2_one['K2']:.4f} ms, torch.atan2 "
        f"{k2_one['torch.atan2']:.4f} ms [{card}]")
    t.update(alternate({
        "K9 plain": lambda: fir_source.fir_tone_step_plain(
            ph7, dp9, a8, off, taps9, 1, FIR_R),
        "K11 -> conv1d": k11_conv,
        # K9 over 4 outputs (probes.rotating: 67 MB, past the L2), and on one
        "K9": probes.rotating(lambda i: (), lambda: fir_source.fir_tone_step(
            ph7, dp9, a8, off, taps9, 1, FIR_R)),
        "K9 one": lambda: fir_source.fir_tone_step(ph7, dp9, a8, off, taps9, 1,
                                                   FIR_R),
        "K3p plain": lambda: fm_chain.fm_chain_step_planes_plain(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K3p": lambda: fm_chain.fm_chain_step_planes(
            vb, *st, consts, DECIM, DEMOD_GAIN, pipelined=True),
        "K3 beside K3p": lambda: fm_chain.fm_chain_step_planes(
            vb, *st, consts, DECIM, DEMOD_GAIN),
    }, PLAIN_REPS))
    ms = {k: min(v_) for k, v_ in t.items()}
    lib["K2"] = ms["K2 library"]
    log(f"K9 fir_tone_step ({FIR_R} x 128 rows, {FIR_NTAPS} taps): kernel "
        f"{t['K9']} ms over 4 rotating outputs, {t['K9 one']} ms on one; "
        f"plain {t['K9 plain']} ms; K11 -> conv1d(groups=128) "
        f"{t['K11 -> conv1d']} ms [{card}]")
    log(f"K3p fm_chain_step_planes(pipelined=True) ({ROWS} x {2 * M} rows): "
        f"kernel {t['K3p']} ms, K3 {t['K3 beside K3p']} ms, plain "
        f"{t['K3p plain']} ms [{card}]")
    for tile, gs in K9_GEOMS:
        k9_ms = graph_ms(lambda: k9_at(fir_source, tile, gs)(
            ph7, dp9, a8, off, taps9, 1, FIR_R))
        g = fir_source._geometry(FIR_R, 1, FIR_NTAPS, tile, gs)
        log(f"K9 tile {tile} seg_group {gs}: {(FIR_R // tile) * (64 // gs)} "
            f"blocks of {g.NQ} transforms a segment, window +"
            f"{100 * (g.WR - tile) / tile:.0f}%, {g.smem} B shared, "
            f"{'tensor copies of ' + str(g.BR) + ' rows' if g.BR else '16-byte stores'}; "
            f"{k9_ms:.4f} ms [{card}]")
    def first_rows(tile):  # rows K3 folds and transforms for a tile
        return -(-(tile + A) // 32) * 32

    log(f"K3 junction: {first_rows(128)} rows folded and transformed for a "
        f"tile of 128 (+{100 * (first_rows(128) - 128) / 128:.0f}%)")
    for tile in (128, 64):
        smem = fm_chain._pipe_smem(tile, A, L, 2 * M)
        default = fm_chain._pipe_tiles_per_block(
            ROWS // tile, smem,
            torch.cuda.get_device_properties(0).multi_processor_count)
        for G in sorted({default, *K3P_GS}):
            k3p_ms = graph_ms(lambda: fm_chain._pipe(
                vb, *st, consts, DECIM, DEMOD_GAIN, tile, G))
            rows_done = first_rows(tile) + (G - 1) * tile
            mark = " (default)" if G == default else ""
            log(f"K3p tile {tile}, {G} tiles a block{mark}: "
                f"{-(-(ROWS // tile) // G)} blocks, {smem} B shared, junction "
                f"+{100 * (rows_done - G * tile) / (G * tile):.0f}% rows; "
                f"{k3p_ms:.4f} ms [{card}]")
    for kind in ("staged", "live"):
        fir_step_rate(torch, kind, card)

    # 25-28. sharding: K6, then the sharded graphs against the unsharded
    from newsched_tpu_torch.parallel import make_mesh

    k6_err = phase_k6(torch, fm_chain, noise)
    k6_launches = phase_sharded_live(fm_chain, fused_out)
    k3_warm_launches, k3_warm_err = phase_sharded_fused(torch, fm_chain, rows,
                                                        replay_out)
    sharded, shard_err = phase_sharded_receivers(torch, sources, wbfm_chain,
                                                 fir_source, wb, fir)
    k3_err = max(k3_err, k3_warm_err)
    k10_err = max(k10_err, shard_err["K10"])
    k12_err = max(k12_err, shard_err["K12"])
    k9_err = max(k9_err, shard_err["K9"])

    # 29. times
    b6 = noise.group_tensor(3 * K6_ROWS // 64, "cuda")  # shard 3's base
    # "K6": the sharded live graph's launch, the 4 shards of a batch in
    # one grid (its plain version shard by shard); "K6 one shard": one
    # shard's 8192 rows, as each launch was before the one grid
    t.update(alternate({
        "K6 plain": lambda: fm_chain.fm_chain_gen_warm_step_plain(
            g0, amp, consts, DECIM, DEMOD_GAIN, K6_ROWS, K6_WARM, nd=4),
        "K5 beside K6": lambda: fm_chain.fm_chain_gen_step(*k5_args),
        "K6 at 32768": lambda: fm_chain.fm_chain_gen_warm_step(
            b6, amp, consts, DECIM, DEMOD_GAIN, ROWS, warm=K6_WARM),
        "K6 one shard": lambda: fm_chain.fm_chain_gen_warm_step(
            b6, amp, consts, DECIM, DEMOD_GAIN, K6_ROWS, warm=K6_WARM),
        "K6 8 shards": lambda: fm_chain.fm_chain_gen_warm_step(
            g0, amp, consts, DECIM, DEMOD_GAIN, ROWS // 8, warm=K6_WARM, nd=8),
        "K6": lambda: fm_chain.fm_chain_gen_warm_step(
            g0, amp, consts, DECIM, DEMOD_GAIN, K6_ROWS, warm=K6_WARM, nd=4),
    }, PLAIN_REPS))
    ms = {k: min(v_) for k, v_ in t.items()}
    log(f"K6 fm_chain_gen_warm_step, one launch: 4 shards of {K6_ROWS} rows "
        f"{t['K6']} ms, 8 shards of {ROWS // 8} {t['K6 8 shards']} ms (one "
        f"shard's {K6_ROWS} rows {t['K6 one shard']} ms, {ROWS} rows "
        f"{t['K6 at 32768']} ms); K5 at {ROWS} rows {t['K5 beside K6']} ms; "
        f"plain (4 shards) {t['K6 plain']} ms [{card}]")
    # one sharded step is profiled
    for n in MESHES:
        step_rate(torch, "live", f"live, {n} shards", card, mesh=make_mesh(n),
                  profile=n == MESHES[0])
        step_rate(torch, general.vector_source(rows, repeat=True),
                  f"replay, {n} shards", card, mesh=make_mesh(n), profile=False)
    phase_sharded_steps(card)
    # 30-33. graph mode against the loop, parameter changes, the on-card
    # counters, the probes against their plain versions
    graph_launches = phase_graph_mode(rows, wb, fir)
    phase_params()
    phase_counters(torch, fm_chain, noise)
    probe_err = phase_probes(torch, fm_chain)

    # 34. times: graph mode, the chunk, the bench's timer, the probes
    graph_times = phase_graph_times(torch, rows, card)
    pt = phase_probe_times(torch, card)

    # 35-38. K3ag, tags, checkpoints, unbounded runs
    t35 = time.monotonic()
    k3ag = phase_k3ag(torch, fm_chain, noise, replay_out, fused_out)
    phase_tags()
    phase_checkpoints()
    unb = phase_unbounded(fm_chain)

    # 39. times
    for kid in ("K3", "K5", "K6"):
        log(f"K3ag in {kid}: " + ", ".join(
            f"ag={ag} {k3ag['t'][f'{kid} ag={ag}']:.4f} ms" for ag in (1, *AG))
            + f" [{card}]")
    log(f"K3ag plain (ag=2, {ROWS} rows): {k3ag['t']['plain']:.4f} ms [{card}]")
    ms["K3ag"], ms["K3ag plain"] = k3ag["t"]["K3 ag=2"], k3ag["t"]["plain"]
    step = graph_times["live"]
    log(f"unbounded live channelizer under start(): {unb['rate']:.1f} "
        f"Msamples/s into a null_sink (8 checksums copied to the host a "
        f"chunk), {unb['ring rate']:.1f} into the ring (8 batches of audio "
        f"a chunk), beside the graph-mode step of phase 34, {step:.4f} ms "
        f"= {BATCH / step / 1e3:.1f} Msamples/s [{card}]")
    phase_pacing(card)
    log(f"phases 35-39: {time.monotonic() - t35:.1f} s")

    # 40-43. K9 past the FFT's taps; the chains and K1 past 64 channels
    t40 = time.monotonic()
    k9p = phase_k9_part(torch, fir_source)
    k9p["err"] = max(k9p["err"], shard_err["K9p"])  # phase 28's one launch
    t41 = time.monotonic()
    wide_err = phase_wide_kernels(torch, fm_chain, noise)
    wide_err["K3"] = max(wide_err["K3"],
                         phase_chain_instances(torch, fm_chain, noise))
    t42 = time.monotonic()
    wide = phase_wide_graphs(torch, fm_chain, noise, channelizer)
    t43 = time.monotonic()
    ms.update(phase_wide_times(torch, fm_chain, channelizer, fir_source,
                               noise, card))
    log(f"phases 40-43: {time.monotonic() - t40:.1f} s (40 {t41 - t40:.1f}, "
        f"41 {t42 - t41:.1f}, 42 {t43 - t42:.1f}, 43 "
        f"{time.monotonic() - t43:.1f})")

    # 44-49. config #3's engines, graph and sharded FIR; config #1
    # de-emphasised; the block library's DSP half; K1 past 256 channels
    t44 = time.monotonic()
    phase_engines(torch, card)
    phase_config3(torch, card)
    phase_sharded_fir(torch)
    phase_deemph(torch, wb, card, ms["K10"])
    phase_dsp_blocks(torch)
    t49 = time.monotonic()
    k1w = phase_k1_wide(torch, channelizer, noise, card)
    ms.update(k1w["ms"])
    log(f"phases 44-49: {time.monotonic() - t44:.1f} s (49 "
        f"{time.monotonic() - t49:.1f})")

    # 50-53. the digital and FEC half: S1-S3, the QPSK and FEC links
    t50 = time.monotonic()
    lp = phase_loops(torch, kloops, card)
    t51 = time.monotonic()
    vt = phase_viterbi(torch, kfec, card)
    vr = phase_viterbi_routes(torch, kfec, card)
    t52 = time.monotonic()
    main_loops = loops_on_main_path_shapes(torch, kloops, card)
    qp = phase_qpsk_link(torch, card)
    t53 = time.monotonic()
    fl = phase_fec_link(torch, kfec, card)
    log(f"phases 50-53: {time.monotonic() - t50:.1f} s (50 {t51 - t50:.1f}, "
        f"51 {t52 - t51:.1f}, 52 {t53 - t52:.1f}, 53 "
        f"{time.monotonic() - t53:.1f})")
    # 54-58. the host boundary: ingest, config #2 fed from a file and over
    # TCP, and their loop-mode times
    t54 = time.monotonic()
    io_path = io_file()
    phase_ingest(io_path, card)
    t55 = time.monotonic()
    ff = phase_file_fed(torch, fm_chain, channelizer, io_path)
    t57 = time.monotonic()
    tcp_launches = phase_tcp(torch, fm_chain, io_path, ff["mem"]["fused"])
    t58 = time.monotonic()
    phase_file_fed_times(torch, io_path, card, graph_times)
    log(f"phases 54-58: {time.monotonic() - t54:.1f} s (54 {t55 - t54:.1f}, "
        f"55-56 {t57 - t55:.1f}, 57 {t58 - t57:.1f}, 58 "
        f"{time.monotonic() - t58:.1f})")
    # 59-62. partitions: config #2 across an edge, config #1 retuned in a
    # child process, the examples; the chains past their tile's audio FIR
    t59 = time.monotonic()
    part = phase_partitioned(torch, fm_chain, noise, card)
    t60 = time.monotonic()
    radio = phase_retune(torch, sources, wbfm_chain, card)
    t61 = time.monotonic()
    phase_examples()
    t62 = time.monotonic()
    phase_long_audio_fir(torch, fm_chain, noise)
    log(f"phases 59-62: {time.monotonic() - t59:.1f} s (59 {t60 - t59:.1f}, "
        f"60 {t61 - t60:.1f}, 61 {t62 - t61:.1f}, 62 "
        f"{time.monotonic() - t62:.1f})")
    for kid in ("S1", "S2"):
        ms[kid], ms[kid + " plain"] = (main_loops["ms"][kid],
                                       main_loops["plain"][kid])
    ms["S3"], ms["S3 plain"] = vt["t"]["S3"], vt["t"]["S3 plain"]
    ms.update(pt["t"])
    lib["window_copy"] = pt["t"]["window_copy library"]
    lib["planes_unpack"] = pt["t"]["planes_unpack library"]
    ms["ablate plain"] = ms["K3 plain"]
    log(f"script time before the bounds: {time.monotonic() - t_start:.1f} s")

    # K3's family beside the dense-DFT chain's times (PERF.md section 6:
    # chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W)
    dense_ms = {"K3": 0.1909, "K5": 0.2061, "K6 one shard": 0.1714,
                "K3p": 0.1717}
    log("K3's family, FFT against the dense DFT's times: " + ", ".join(
        f"{k} {ms[k]:.4f} ms ({v:.4f}, {v / ms[k]:.2f}x)"
        for k, v in dense_ms.items()) + f" [{card}]")
    bounds = kernel_bounds()
    # the probes: each input read once, each output written once
    bounds["window_copy"] = bound(pt["x_bytes"] + pt["n_tiles"] * 8 * 128 * 4, 0)
    bounds["planes_unpack"] = bound(2 * pt["stream_bytes"], 0)
    bounds["ablate"] = bounds["K3"]  # its "full" instance is K3
    bounds["K3ag"] = bounds["K3"]  # K3's function, its audio stage banded
    bounds.update(k1w["bound"])  # K1 past 448 channels, DENSE_ROWS rows
    bounds.update(main_loops["bounds"])  # at the QPSK link's shapes
    bounds["S3"] = vt["bound"]  # a batch of the FEC link
    for mw in STREAM_M:  # phase 43's shapes: 16384 rows, K6 over 4 shards
        cb = chain_bounds(mw, WIDE_ROWS, WIDE_ROWS, nd=4)
        bounds.update({f"{kid} M={mw}": cb[kid] for kid in ("K3", "K5", "K6")})
    bounds.update(vr["bound"])  # each route at its link's batch
    ms.update(vr["t"])
    for name, (b_ms, by) in bounds.items():
        log(f"bound {name}: {b_ms:.4f} ms ({by}); kernel {ms[name]:.4f} ms, "
            f"roofline share {100 * b_ms / ms[name]:.1f}% [{card}]")
    log(f"graph-mode launches on the main paths of phase 30: {graph_launches}")

    def entry(name, kid, src, replaces, launches, err):
        if not replaces.startswith(("bench/", "newsched_tpu/")):
            replaces = f"newsched_tpu/ops/pallas/{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"newsched_tpu_torch/csrc/{src}",
                "replaces": replaces,
                "launches": launches, "max_abs_err": err,
                "ms": ms[kid], "plain_ms": ms[kid + " plain"],
                "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1],
                "library_ms": lib.get(kid)}

    wl = wb["launches"]
    print(json.dumps({"kernels": [
        entry("fm_chain_step_planes", "K3", "fm_chain.cu", "fm_chain.py:421",
              launches["fm_chain"] + k3_warm_launches + ff["launches"]["K3"]
              + tcp_launches + part["K3"], k3_err),
        entry("gaussian_rows", "K4", "noise.cu", "noise.py:176",
              launches["noise"] + part["K4"], k4_err),
        entry("arm_fold_dft", "K1", "channelizer.cu", "channelizer.py:209",
              staged["arm_fold_dft"] + ff["launches"]["K1"],
              fold_err["arm_fold_dft"]),
        entry("arm_fold", "K7", "channelizer.cu", "channelizer.py:95",
              dec_launches + k1w["launches"]["K7"], fold_err["arm_fold"]),
        entry("fm_chain_gen_step", "K5", "fm_chain.cu", "fm_chain.py:591",
              live_launches, k5_err),
        entry("nco_planes", "K8", "sources.cu", "sources.py:44",
              wl["staged"]["K8"] + wl["fused"]["K8"]
              + fir["launches"]["staged"]["K8"] + sharded["K8"] + radio["K8"],
              nco_err["K8"]),
        entry("nco_folded", "K11", "sources.cu", "sources.py:91",
              wl["folded"]["K11"], nco_err["K11"]),
        entry("wbfm_chain_step", "K10", "wbfm_chain.cu", "wbfm_chain.py:364",
              wl["fused"]["K10"] + wl["folded"]["K10"] + sharded["K10"]
              + radio["K10"], k10_err),
        entry("wbfm_chain_live_step", "K12", "wbfm_chain.cu",
              "wbfm_chain.py:452", wl["live"]["K12"] + sharded["K12"], k12_err),
        entry("fir_tone_step", "K9", "fir_source.cu", "fir_source.py:89",
              fir["launches"]["live"]["K9"] + sharded["K9"], k9_err),
        entry("fm_chain_step_planes[pipelined]", "K3p", "fm_chain.cu",
              "fm_chain.py:315", k3p["launches"], k3p["err"]),
        entry("fm_chain_gen_warm_step", "K6", "fm_chain.cu", "fm_chain.py:724",
              k6_launches, k6_err),
        entry("window_copy", "window_copy", "probes.cu", "bench/exp_dma.py:93",
              pt["launches"]["window_copy"], probe_err["window_copy"]),
        entry("planes_unpack", "planes_unpack", "probes.cu",
              "bench/exp_prep.py:119", pt["launches"]["planes_unpack"],
              probe_err["planes_unpack"]),
        entry("fm_chain_step_planes[ablate]", "ablate", "fm_chain.cu",
              "bench/exp_ablate.py:128", pt["launches"]["ablate"],
              probe_err["ablate"]),
        entry("fm_chain_step_planes[audio_groups]", "K3ag", "fm_chain.cu",
              "fm_chain.py:251", k3ag["launches"], k3ag["err"]),
        entry("fir_tone_step[partitioned]", "K9p", "fir_part.cu",
              "fir_source.py:89", k9p["launches"], k9p["err"]),
        entry("fm_chain_step_planes[M=128]", "K3w", "fm_chain.cu",
              "fm_chain.py:421", wide[128]["fused"], wide_err["K3"]),
        entry("fm_chain_gen_step[M=128]", "K5w", "fm_chain.cu",
              "fm_chain.py:591", wide[128]["live"], wide_err["K5"]),
        entry("fm_chain_gen_warm_step[M=128]", "K6w", "fm_chain.cu",
              "fm_chain.py:724", wide[128]["K6"], wide_err["K6"]),
        entry("arm_fold_dft[M=128]", "K1w", "channelizer.cu",
              "channelizer.py:209", wide[128]["K1"], fold_err["arm_fold_dft"]),
        # K1 at P = 8 .. 16 (the run-time instance; phase 49's graphs and
        # pfb_channelize calls)
        *[entry(f"arm_fold_dft[M={m}]", f"K1 M={m}", "channelizer.cu",
                "channelizer.py:209", k1w["launches"][m], fold_err[f"K1 M={m}"])
          for m in K1_WIDE_M if m > 448],
        # chain_tile_stream past 256 channels (phase 42's graphs)
        *[entry(f"{name}[M={mw}]", f"{kid} M={mw}", "fm_chain.cu", ref,
                wide[mw][kind], wide_err[kid])
          for mw in STREAM_M
          for name, kid, ref, kind in (
              ("fm_chain_step_planes", "K3", "fm_chain.py:421", "fused"),
              ("fm_chain_gen_step", "K5", "fm_chain.py:591", "live"),
              ("fm_chain_gen_warm_step", "K6", "fm_chain.py:724", "K6"))],
        # no TPU kernel: each replaces a lax.scan of the reference
        entry("costas_loop", "S1", "loops.cu", "newsched_tpu/ops/loops.py:88",
              qp["launches"]["costas_loop"],
              max(lp["err"]["S1"], main_loops["err"]["S1"])),
        entry("clock_recovery_mm", "S2", "loops.cu",
              "newsched_tpu/ops/loops.py:165",
              qp["launches"]["clock_recovery_mm"],
              max(lp["err"]["S2"], main_loops["err"]["S2"])),
        entry("viterbi_decode", "S3", "viterbi.cu", "newsched_tpu/ops/fec.py:83",
              fl[FEC_SIGMA_7DB]["launches"], 0.0),
        # S3's routes past the FEC link's frames and codes (phase 51's links)
        *[entry(f"viterbi_decode[{name}]", f"S3 {name}", "viterbi.cu",
                "newsched_tpu/ops/fec.py:83", vr["launches"][name], 0.0)
          for name, *_ in S3_ROUTES],
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--radio"]:
        sys.exit(radio_child(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--phases"]:
        sys.exit(late_phases(sys.argv[2:]))
    sys.exit(main())
