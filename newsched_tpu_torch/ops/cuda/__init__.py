"""Hand-written CUDA kernels for Hopper (reference:
newsched_tpu/ops/pallas). Each module holds a kernel's wrapper, its plain
PyTorch version and its launch count; the sources are ../../csrc/*.cu,
built by _build.py at first use."""


def launch_counters() -> list[tuple[object, str]]:
    """(wrapper, attribute) of every launch count of the kernels that a
    flowgraph step may launch: the runner reads them around a graph
    capture and adds a captured chunk's launches once per replay."""
    from newsched_tpu_torch.ops.cuda import (channelizer, fec, fir_source,
                                             fm_chain, loops, mathfns, noise,
                                             scan, sources, wbfm_chain)

    fns = (noise.gaussian_rows, fm_chain.fm_chain_step_planes,
           fm_chain.fm_chain_gen_step, fm_chain.fm_chain_gen_warm_step,
           mathfns.atan2, channelizer.arm_fold, channelizer.arm_fold_dft,
           sources.nco_planes, sources.nco_folded,
           wbfm_chain.wbfm_chain_step, wbfm_chain.wbfm_chain_live_step,
           fir_source.fir_tone_step, loops.costas_loop,
           loops.clock_recovery_mm, fec.viterbi_frames, scan.iir_scan,
           scan.agc_scan)
    banded = (fm_chain.fm_chain_step_planes, fm_chain.fm_chain_gen_step,
              fm_chain.fm_chain_gen_warm_step)
    return [(f, "launches") for f in fns] + [
        (fm_chain.fm_chain_step_planes, "pipe_launches"),
        (fir_source.fir_tone_step, "partitioned_launches"),
        (fec.viterbi_frames, "block_launches"),
        (fec.viterbi_frames, "cluster_launches"),
        (fec.viterbi_frames, "serial_launches"),
        (fec.viterbi_frames, "global_launches"),
        (fec.viterbi_frames, "metric_launches")] + [
        (f, f"ag{ag}_launches") for f in banded for ag in (2, 4)]
