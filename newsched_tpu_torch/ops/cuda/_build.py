"""Build and load the port's hand-written CUDA kernels.

Every ``newsched_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``), one nvcc process per source, all started together,
and the objects are linked into ONE shared library with a plain C
interface, loaded with ctypes. The build happens at first use, into ``build/kernels/``
at the repository root; the library's file name carries a hash of the
sources and flags, so an edited source is never served by a stale build.

Nothing here runs at import: a CPU-only machine imports every module of the
port and never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_LL = ctypes.c_longlong

# C signature of every launcher: (argtypes); all return a cudaError_t as int.
SIGNATURES = {
    # noise.cu
    "gaussian_rows_launch": [_P, _LL, _I, _P, _U, _U, _I, _F, _F, _I, _P, _I,
                             _I, _I, _I, _P],
    # fm_chain.cu
    "fm_chain_planes_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                               _P, _F, _P, _P],
    "fm_chain_ablate_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
                               _P],
    "fm_chain_pipe_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
                             _P],
    "fm_chain_gen_launch": [_P, _U, _U, _I, _F, _F, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _F, _P, _P],
    "fm_chain_gen_warm_launch": [_P, _LL, _I, _U, _U, _I, _F, _F, _P, _P, _P, _P,
                                 _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _F, _P, _P],
    "fm_chain_handoff_reset": [_P, _I, _P],
    "atan2_launch": [_P, _P, _P, _LL, _P, _P],
    # channelizer.cu
    "arm_fold_launch": [_P, _LL, _P, _P, _LL, _I, _I, _I, _P],
    "arm_fold_geometry": [_I, _I, _I, _LL, _P],
    "arm_fold_fft_launch": [_P, _LL, _P, _P, _P, _LL, _I, _I, _I, _P],
    # sources.cu
    "nco_planes_launch": [_P, _P, _P, _LL, _P, _P, _P, _P],
    "nco_folded_launch": [_P, _P, _P, _I, _P, _P, _P],
    # fir_source.cu
    "fir_tone_launch": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P, _P],
    # fir_part.cu
    "fir_part_launch": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P, _P],
    # wbfm_chain.cu
    "wbfm_chain_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _F, _F, _F, _P, _P],
    "wbfm_live_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P],
    # probes.cu
    "window_copy_launch": [_I, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "planes_unpack_launch": [_P, _P, _P, _P, _I, _I, _P],
    # loops.cu
    "costas_launch": [_P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _I,
                      _I, _LL, _P],
    "mm_launch": [_P] * 17 + [_P, _P, _F, _F, _F, _F, _I, _I, _LL, _I, _I,
                              _P],
    # viterbi.cu
    "viterbi_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    "viterbi_acs_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    # scan.cu
    "iir_scan_launch": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                        _P, _P, _P, _P, _P, _I, _P],
    "agc_scan_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _F, _F, _F, _P, _P,
                        _P, _I, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused the sources."""


class _Built:
    lib: ctypes.CDLL | None = None
    seconds: float = 0.0
    log: str = ""


_built = _Built()
_lock = threading.Lock()


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if nvcc is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        nvcc = os.path.join(home, "bin", "nvcc")
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "of newsched_tpu_torch are built from csrc/ at first use on a "
            "machine with the CUDA toolkit")
    return nvcc


def _compile(sources: list[Path], so: Path) -> str:
    """nvcc -c for every source in parallel, then one link; returns the
    compilers' output. The library appears under its final name only
    when complete."""
    nvcc = _find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{s.stem}.{so.stem}.{tag}.o") for s in sources]
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True), s)
             for s, o in zip(sources, objs)]
    log, failed = [], []
    for proc, src in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    if not failed:
        tmp = so.with_suffix(f".{tag}")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
        else:
            os.replace(tmp, so)
    for o in objs:
        o.unlink(missing_ok=True)
    text = "".join(log)
    if failed:
        raise KernelBuildError(f"nvcc failed: {', '.join(failed)}\n{text}")
    return text


def build() -> _Built:
    """Compile (once per process, and only if the hashed library is not
    already on disk) and load the kernel library. Raises KernelBuildError."""
    with _lock:
        if _built.lib is not None:
            return _built
        sources = sorted(CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in sources + sorted(CSRC.glob("*.cuh")):
            h.update(s.name.encode())
            h.update(s.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libnewsched_kernels_{h.hexdigest()[:16]}.so"
        t0 = time.monotonic()
        if not so.exists():
            _built.log = _compile(sources, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _built.seconds = time.monotonic() - t0
        _built.lib = lib
        return _built


def lib() -> ctypes.CDLL:
    return build().lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def device_scalar(x, name: str, *, device, dtype):
    """A piece of stream state as a kernel reads it: a one-element tensor
    of ``dtype`` on ``device`` (the blocks keep their NCO phases, group
    counters and flags there, so a captured step reads the value the step
    before it left). A host value, as a test or a probe passes one, is
    uploaded here; a tensor must already be on the device with that dtype.
    Never called on a host value inside a graph capture: the upload would
    end the capture with an error."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.device != torch.device(device) or x.dtype != dtype \
                or x.numel() != 1:
            raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}, the kernel reads one {dtype} on "
                             f"{device}")
        return x
    return torch.tensor(x, dtype=dtype, device=device)


def scalar_arg(x, name: str, device) -> tuple[int, float]:
    """A settable float32 parameter as the kernels take it: (the pointer of
    a 0-dim float32 tensor on ``device``, 0.0), so a captured graph reads
    the value the card holds at replay, or (0, the host number)."""
    import torch

    if isinstance(x, torch.Tensor):
        return device_scalar(x, name, device=device,
                             dtype=torch.float32).data_ptr(), 0.0
    return 0, float(np.float32(x))


def check_tensor(t, name: str, *, device, shape: tuple | None = None) -> None:
    """What a kernel takes: a contiguous float32 CUDA tensor on ``device``
    (of ``shape`` when given). Raises ValueError on anything else."""
    import torch

    if t.device.type != "cuda" or t.device != torch.device(device):
        raise ValueError(f"{name}: on {t.device}, the kernel runs on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes float32")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
