"""Export GRC 4.0 block metadata for the port's whole block library (the
twin of scripts/export_grc.py; the reference's blockbuilder emits a GRC
yml a block at build time).

    python3 -m newsched_tpu_torch.export_grc [--out grc/]

Walks every Block subclass in the same modules of newsched_tpu_torch.blocks
as the reference script (MODULES), makes each with representative
arguments (EXAMPLE_ARGS for blocks whose constructors need them), renders
runtime/blockspec.grc_yaml and writes <out>/<module>_<block>.block.yml.
Blocks that cannot be made headless (soapy, alsa where their libraries
are missing) are listed at the end. It renders with PyYAML, which the
card's machine lacks: it runs on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import tempfile

import numpy as np

MODULES = ["general", "math", "analog", "filter", "fft", "streamops",
           "fileio", "digital", "fec", "zmq", "network", "gui", "audio",
           "vector_dsp", "yml_blocks"]

_TAPS = np.ones(8, np.float32) / 8

# Representative constructor arguments for blocks that require them (the
# reference script's table; the port has no cf32 fm_channelizer_fused).
EXAMPLE_ARGS: dict[str, tuple] = {
    "head": (1024,),
    "throttle": (1e6,),
    "vector_source": (np.zeros(16, np.complex64),),
    "load": (4,),
    "fanout": (2,),
    "add": (2,),
    "multiply": (2,),
    "add_const": (1.0, "cf32"),
    "multiply_const": (1.0, "cf32"),
    "sig_source": (1e6,),
    "fm_deemph": (48000.0,),
    "fm_preemph": (48000.0,),
    "fir_filter": (_TAPS,),
    "iir_filter": ([1.0, 0.5], [1.0, -0.2]),
    "fft_filter": (_TAPS,),
    "moving_average": (8,),
    "pfb_channelizer": (8,),
    "pfb_decimator": (8,),
    "rational_resampler": (2, 3),
    "freq_xlating_fir": (_TAPS, 1e5, 1e6),
    "fft": (64,),
    "file_source": (os.devnull,),
    "file_sink": (os.devnull,),
    "delay": (4,),
    "skiphead": (4,),
    "keep_one_in_n": (4,),
    "keep_m_in_n": (2, 4),
    "repeat": (2,),
    "interleave": (2,),
    "deinterleave": (2,),
    "stream_to_vector": (8,),
    "vector_to_stream": (8,),
    "streams_to_vector": (2,),
    "vector_to_streams": (2,),
    "chunks_to_symbols": (np.asarray([1 + 0j, -1 + 0j], np.complex64),),
    "constellation_decoder": (np.asarray([1 + 0j, -1 + 0j], np.complex64),),
    "binary_slicer": (),
    "clock_recovery_mm": (4.0,),
    "costas_loop": (0.05,),
    "diff_decoder": (2,),
    "diff_encoder": (2,),
    "interleaver": (64, 8),
    "deinterleaver_blk": (64, 8),
    "push_sink": ("tcp://127.0.0.1:5555",),
    "pull_source": ("tcp://127.0.0.1:5555",),
    "pub_sink": ("tcp://127.0.0.1:5556",),
    "sub_source": ("tcp://127.0.0.1:5556",),
    "udp_source": (5557,),
    "udp_sink": (5557, "127.0.0.1"),
    "tcp_source": (5558,),
    "tcp_sink": (5558, "127.0.0.1"),
    "wav_sink": (os.devnull,),
    "time_sink": (),
    "freq_sink": (),
    "vector_quad_demod": (8,),
    "vector_fir": (8, _TAPS),
    "channel_select": (8, 0),
    "fm_channelizer_fused_planes": (64, None, _TAPS),
    "fm_noise_channelizer_source": (64, None, _TAPS),
    "wbfm_rcv_fused": (_TAPS, 100e3, 1e6),
    "wbfm_live_source": (_TAPS, 100e3, 1e6),
    "sig_source_folded": (1e6,),
    "fir_tone_source": (1e6, _TAPS),
    "cplx_to_planes": (8,),
    "noise_planes_source": (8,),
}
EXAMPLE_KWARGS: dict[str, dict] = {
    "keep_one_in_n_y": {"n": 4},
    "keep_m_in_n_y": {"m": 2, "n": 4},
    "repeat_y": {"n": 2},
    "stream_to_vector_y": {"vlen": 8},
    "vector_to_stream_y": {"vlen": 8},
}
SKIP = {"Block", "SyncBlock", "HierBlock"}


def export(outdir: str) -> tuple[int, list[str]]:
    """Write every block's yml under ``outdir``; returns (files written,
    blocks skipped with the reason)."""
    import scipy.io.wavfile

    from newsched_tpu_torch.runtime.block import Block
    from newsched_tpu_torch.runtime.blockspec import grc_yaml

    os.makedirs(outdir, exist_ok=True)
    written, skipped = 0, []
    with tempfile.TemporaryDirectory() as td:
        # wav_source reads a WAV when it is made: a tiny one
        wav = os.path.join(td, "probe.wav")
        scipy.io.wavfile.write(wav, 8000, np.zeros(16, np.float32))
        example_args = {**EXAMPLE_ARGS, "wav_source": (wav,)}
        for modname in MODULES:
            try:
                mod = importlib.import_module(f"newsched_tpu_torch.blocks.{modname}")
            except ImportError as e:  # a hardware library missing
                skipped.append(f"{modname}.* ({e.__class__.__name__})")
                continue
            for name, cls in sorted(vars(mod).items()):
                if not (inspect.isclass(cls) and issubclass(cls, Block)):
                    continue
                if name.startswith("_") or name in SKIP:
                    continue
                if cls.__module__ != mod.__name__ and modname != "yml_blocks":
                    continue  # re-exported from elsewhere
                try:
                    inst = cls(*example_args.get(name, ()),
                               **EXAMPLE_KWARGS.get(name, {}))
                    doc = grc_yaml(inst, module=modname)
                except Exception as e:  # recorded: the block is listed as skipped
                    skipped.append(f"{modname}.{name} ({e.__class__.__name__}: {e})")
                    continue
                with open(os.path.join(outdir, f"{modname}_{name}.block.yml"),
                          "w") as fh:
                    fh.write(doc)
                written += 1
    return written, skipped


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="grc")
    args = ap.parse_args(argv)
    written, skipped = export(args.out)
    print(f"wrote {written} GRC block descriptions to {args.out}/")
    if skipped:
        print(f"skipped {len(skipped)}:")
        for s in skipped:
            print(f"  - {s}")


if __name__ == "__main__":
    main()
