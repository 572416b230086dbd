"""Streaming FIR filter (reference: newsched_tpu/ops/fir.py), the parts the
staged flagship's ``vector_fir`` and the wideband-FM receiver's xlate
filter and resampler reach.

A whole batch is filtered at once, carrying the last ``ntaps-1`` input
samples between batches as explicit state:

    y[n] = sum_t taps[t] * x[n - t],   x[<0] = 0

Every function here works along the LAST axis and takes any leading batch
axes, so the M channels of a vector stream are filtered in one batched
product (the reference vmaps its per-channel filter instead).

Compute paths, selected by ``method``:

- ``"mxu"``: frames the output into tiles of 128 and contracts each frame's
  haloed input window against a Toeplitz tap matrix: one
  (frames, F*decim+T-decim) @ (F*decim+T-decim, F) product.
- ``"conv"``: the strided correlation, as windows of the input times the
  reversed taps.

Both run as FP32 matrix products (``torch.matmul`` with TF32 off, torch's
default), which is what the reference's HIGHEST precision asks for; lower
precision cost the reference ~18 dB of SNR on the 65-tap audio FIR. The
products are plain ops outside any kernel, as in the reference (XLA's
matmul there). ``"mxu3"``, the reference's three-pass bf16 Toeplitz tier
(config #0's staged filter), takes the FP32 Toeplitz path of ``"mxu"``:
on the H100 FP32 is the accurate choice, and the bf16 split exists only
for the TPU's matrix unit.

- ``"fft"``: overlap-save fast convolution (``fft_filter_full``), the core
  of the fft_filter block (config #3), on one of two engines:
  ``fft_method="xla"``, the native transform pair (``torch.fft``: cuFFT on
  the card; ``rfft``/``irfft`` for real streams), or ``"mxu"``, the Bailey
  128 x 128 fast convolution (ops/fftops.py: three complex FP32 products).
  ``"auto"`` follows ``fft_engine``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops import fftops

_MXU_FRAME = 128
METHODS = ("auto", "mxu", "conv", "fft", "mxu3")


class FirState(NamedTuple):
    """Inter-batch FIR state: the last ntaps-1 input samples (along the
    last axis; leading axes as the stream's)."""

    tail: torch.Tensor


def fir_init_state(ntaps: int, device, dtype=torch.complex64,
                   batch_shape: tuple = ()) -> FirState:
    return FirState(tail=torch.zeros((*batch_shape, max(ntaps - 1, 0)),
                                     dtype=dtype, device=device))


def _mm(Z: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Z @ H in FP32 real products, for real or complex Z and H (complex
    operands decomposed into planes, as the reference does to keep control
    of precision)."""
    if not Z.is_complex() and not H.is_complex():
        return Z.to(torch.float32) @ H.to(torch.float32)
    if Z.is_complex() and not H.is_complex():
        return torch.complex(Z.real @ H, Z.imag @ H)
    if Z.is_complex():
        zr, zi, hr, hi = Z.real, Z.imag, H.real, H.imag
        return torch.complex(zr @ hr - zi @ hi, zr @ hi + zi @ hr)
    Z = Z.to(torch.float32)
    return torch.complex(Z @ H.real, Z @ H.imag)


def _toeplitz_taps(taps_rev: np.ndarray, frame: int, decim: int) -> np.ndarray:
    """Tap matrix H[s, j] = taps_rev[s - j*decim] (zero outside range).

    Contracting a haloed input frame Z[i, s] (s over (frame-1)*decim + ntaps)
    against H yields y[i*frame + j] = sum_u taps_rev[u] * Z[i, j*decim + u].
    """
    t = np.asarray(taps_rev)
    ntaps = t.shape[0]
    srange = (frame - 1) * decim + ntaps
    H = np.zeros((srange, frame), dtype=t.dtype)
    for j in range(frame):
        H[j * decim: j * decim + ntaps, j] = t
    return H


class FftTaps(NamedTuple):
    """The "fft" method's constants on a device (``fft_taps``): the engine
    and transform size resolved for one batch shape, and the taps as that
    engine takes them."""

    engine: str                  # "xla" (torch.fft) or "mxu" (Bailey)
    fft_size: int
    spectrum: torch.Tensor | None            # "xla": fft/rfft of the taps
    bailey: fftops.BaileyConsts | None       # "mxu"
    auto: bool                   # the engine was fft_method="auto"'s pick
    complex_stream: bool         # built for a complex stream (else real)


class FirTaps(NamedTuple):
    """One filter's host taps on a device, for one output length and
    decimation (``fir_taps``)."""

    rev: torch.Tensor       # (ntaps,) the taps reversed, for "conv"
    toeplitz: torch.Tensor | None  # the "mxu" tap matrix (_toeplitz_taps)
    fft: FftTaps | None = None     # the "fft" method's (fft_taps)


def _resolve_method(method: str, ntaps: int, taps_static: bool,
                    decim: int) -> str:
    """The compute path ``fir_filter`` takes for ``method`` (the
    reference's "auto" rule; "mxu3" is the FP32 Toeplitz path here, and
    tensor taps take "conv" in place of "mxu")."""
    if method not in METHODS:
        raise ValueError(f"unknown FIR method {method!r}")
    if method == "auto":
        if ntaps > 384:
            method = "fft"
        elif taps_static and decim <= max(4, ntaps // 8):
            method = "mxu"
        else:
            method = "conv"
    if method == "mxu3":
        method = "mxu"  # FP32 on the card: see the module docstring
    if method == "mxu" and not taps_static:
        method = "conv"  # the tap matrix is built from host taps
    return method


def fir_taps(taps, n_out: int, decim: int, device, method: str = "auto",
             complex_stream: bool = True, fft_method: str = "auto",
             fft_size: int | None = None) -> FirTaps:
    """Host ``taps`` as the device constants of ``fir_filter`` for batches
    of ``n_out`` outputs. Blocks build them once per device and batch
    shape; a direct call of ``fir_filter`` without them builds them for
    that call. Where ``method`` resolves to "fft", the FFT constants are
    built for a stream that is complex (``complex_stream``) or real, and
    the Toeplitz matrix is not."""
    taps = np.asarray(taps)
    dtype = np.complex64 if np.iscomplexobj(taps) else np.float32
    rev = np.array(taps[::-1], dtype)  # a copy: 1-tap views keep stride -1
    m = _resolve_method(method, len(taps), True, decim)
    ft, H = None, None
    if m == "fft":
        ft = fft_taps(taps, n_out * decim, complex_stream, device, fft_method,
                      fft_size)
    else:
        H = torch.tensor(_toeplitz_taps(rev, min(_MXU_FRAME, n_out), decim),
                         device=device)
    return FirTaps(rev=torch.tensor(rev, device=device), toeplitz=H, fft=ft)


def _frame_with_halo(xfull: torch.Tensor, nframes: int, stride: int,
                     srange: int) -> torch.Tensor:
    """Z[..., i, s] = xfull[..., i*stride + s] for i < nframes, s < srange
    (zeros past the end of xfull): a strided view where no padding is
    needed."""
    need = (nframes - 1) * stride + srange
    pad = need - int(xfull.shape[-1])
    if pad > 0:
        xfull = torch.cat([xfull, xfull.new_zeros((*xfull.shape[:-1], pad))], -1)
    return xfull.unfold(-1, srange, stride)[..., :nframes, :]


def _mxu_fir(xfull: torch.Tensor, H: torch.Tensor, n_out: int,
             decim: int) -> torch.Tensor:
    """Toeplitz-matmul FIR. xfull includes the ntaps-1 halo at the front;
    H is the tap matrix of ``fir_taps``, (srange, frame)."""
    srange, frame = int(H.shape[0]), int(H.shape[1])
    nframes = -(-n_out // frame)
    Z = _frame_with_halo(xfull, nframes, frame * decim, srange)
    y = _mm(Z, H)  # (..., nframes, frame)
    return y.reshape(*y.shape[:-2], nframes * frame)[..., :n_out]


def _conv1d(x: torch.Tensor, kernel_rev: torch.Tensor, stride: int = 1):
    """Valid-mode correlation along the last axis with an (already
    reversed) kernel: y[..., i] = sum_u kernel_rev[u] * x[..., i*stride + u].
    Windows times the kernel, an FP32 product: a cuDNN convolution would
    run in TF32 on the card by default."""
    K = int(kernel_rev.shape[0])
    Z = x.unfold(-1, K, stride)  # (..., n_windows, K)
    return _mm(Z, kernel_rev[:, None])[..., 0]


# ---------------------------------------------------------------------------
# FFT overlap-save path

FFT_METHODS = ("auto", "xla", "mxu")


def _good_fft_size(n: int) -> int:
    """Next 5-smooth size >= n (the reference's rule; cuFFT, like XLA's
    FFT, takes 2^a 3^b 5^c directly)."""
    best = 1 << (n - 1).bit_length()
    x = 1
    while x < best:
        y = x
        while y < best:
            z = y
            while z < best:
                z *= 5
            if n <= z < best:
                best = z
            y *= 3
        x *= 2
    return best


def _auto_fft_size(ntaps: int, n_lin: int) -> int:
    """The reference's adaptive segment size: scale with the batch up to
    16384 while keeping >= 4x the taps, and no larger than the batch's
    one segment."""
    size = max(_good_fft_size(4 * ntaps),
               min(_good_fft_size(max(n_lin // 128, 1)), 16384), 4096)
    return min(size, _good_fft_size(n_lin + ntaps - 1))


def fft_engine(fft_method: str, complex_stream: bool, taps_static: bool,
               fft_size: int | None) -> str:
    """The engine of the "fft" method: "xla" or "mxu", with the
    reference's errors for an "mxu" its constraints refuse.

    "auto" is "xla", the native transform pair, on every device. The
    reference picks "mxu" on an accelerator when its constraints hold
    (complex stream, host taps, fft_size 16384 or None, a batch of at
    least one 120-row segment), because on the TPU its three matrix
    products beat the FFT. On the H100 they do not: at config #3's shape
    (1024 taps, 2^21 complex samples, 4 rotating inputs) chip_smoke.py
    phase 44 timed the cuFFT engine at 0.0952 ms a batch and the Bailey
    products at 0.2246 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md section
    6). On the CPU the reference's rule is "xla" too.
    """
    if fft_method not in FFT_METHODS:
        raise ValueError(f"fft_method {fft_method!r} not in auto/xla/mxu")
    if fft_method == "auto":
        return "xla"
    if fft_method == "mxu":
        if not taps_static:
            raise ValueError("fft_method='mxu' needs static (numpy) taps: "
                             "the matrix constants are built from host taps")
        if not complex_stream:
            raise ValueError("fft_method='mxu' is the complex fast-conv; "
                             "real streams use the rfft path")
        if fft_size not in (None, fftops._BAILEY_N):
            raise ValueError("fft_method='mxu' uses the 128x128 "
                             "factorization: fft_size must be 16384/None")
    return fft_method


def fft_taps(taps, n_lin: int, complex_stream: bool, device,
             fft_method: str = "auto", fft_size: int | None = None) -> FftTaps:
    """The "fft" method's constants for batches of ``n_lin`` linear
    outputs (before decimation): the engine (``fft_engine``), the
    transform size, and the taps' spectrum ("xla"; the rfft of real taps
    for a real stream) or the Bailey constants ("mxu")."""
    taps = np.asarray(taps)
    ntaps = len(taps)
    complex_stream = bool(complex_stream or np.iscomplexobj(taps))
    engine = fft_engine(fft_method, complex_stream, True, fft_size)
    if engine == "mxu":
        return FftTaps("mxu", fftops._BAILEY_N, None,
                       fftops.bailey_consts(taps, device), fft_method == "auto",
                       True)
    size = _auto_fft_size(ntaps, n_lin) if fft_size is None else int(fft_size)
    t = torch.tensor(taps, device=device)
    spec = _spectrum(t, size, complex_stream)
    return FftTaps("xla", size, spec, None, fft_method == "auto",
                   complex_stream)


def _spectrum(t: torch.Tensor, size: int, complex_stream: bool) -> torch.Tensor:
    if complex_stream:
        return torch.fft.fft(t.to(torch.complex64), size)
    return torch.fft.rfft(t.to(torch.float32), size)


def fft_filter_full(xfull: torch.Tensor, taps, n_out: int, decim: int = 1,
                    fft_size: int | None = None, fft_method: str = "auto",
                    taps_np: np.ndarray | None = None,
                    consts: FftTaps | None = None) -> torch.Tensor:
    """Overlap-save convolution along the last axis:
    y[..., k] = sum_t taps[t] xfull[..., ntaps-1+k-t].

    xfull carries the ntaps-1 halo at the front; returns n_out samples
    (after decimation by ``decim``), complex64 for a complex stream or
    taps, else float32. Leading axes are batch axes. The batch is cut into
    segments of ``fft_size`` with ntaps-1 overlap, all transformed at once.

    fft_method: "xla" = the native transform pair (``torch.fft``, cuFFT on
    the card, FP32); "mxu" = the Bailey fast convolution (ops/fftops.py,
    FP32 products; host taps, complex stream, fft_size 16384 or None);
    "auto" = ``fft_engine``. ``taps_np`` are the host taps (None for
    tensor taps); ``consts`` the block's ``fft_taps``, built for this call
    when None."""
    ntaps = int(taps.shape[0]) if isinstance(taps, torch.Tensor) else len(taps)
    n_lin = n_out * decim  # linear-convolution outputs before decimation
    complex_stream = bool(xfull.is_complex() or (
        taps.is_complex() if isinstance(taps, torch.Tensor)
        else np.iscomplexobj(taps)))
    if consts is None:
        engine = fft_engine(fft_method, complex_stream, taps_np is not None,
                            fft_size)
        if taps_np is not None:
            consts = fft_taps(taps_np, n_lin, complex_stream, xfull.device,
                              engine, fft_size)
        else:
            size = (_auto_fft_size(ntaps, n_lin) if fft_size is None
                    else int(fft_size))
            consts = FftTaps("xla", size, _spectrum(taps, size, complex_stream),
                             None, False, complex_stream)
    if consts.engine == "mxu":
        y = fftops.bailey_filter(xfull, consts.bailey, n_lin)
        return y[..., ::decim] if decim > 1 else y
    size = consts.fft_size
    step = size - (ntaps - 1)
    if step < 1:
        raise ValueError(f"fft_size {size} must exceed ntaps - 1 = {ntaps - 1}")
    nseg = -(-n_lin // step)
    if complex_stream:
        segs = _frame_with_halo(xfull.to(torch.complex64), nseg, step, size)
        Y = torch.fft.ifft(torch.fft.fft(segs, dim=-1) * consts.spectrum,
                           dim=-1)
    else:
        segs = _frame_with_halo(xfull.to(torch.float32), nseg, step, size)
        Y = torch.fft.irfft(torch.fft.rfft(segs, dim=-1) * consts.spectrum,
                            n=size, dim=-1)
    y = Y[..., ntaps - 1:].reshape(*Y.shape[:-2], -1)[..., :n_lin]
    return y[..., ::decim] if decim > 1 else y


# ---------------------------------------------------------------------------
# public entry point


def fir_filter(taps, state: FirState, x: torch.Tensor, decim: int = 1,
               method: str = "auto", dev_taps: FirTaps | None = None,
               fft_method: str = "auto", fft_size: int | None = None):
    """Filter one batch along the last axis, threading streaming state.

    Args:
      taps: (ntaps,) float32 or complex64 coefficients (h[0] first): a host
        array (numpy, list) or a tensor.
      state: FirState carrying the previous batch's tail.
      x: (..., B) input batch; B must be a multiple of decim.
      decim: keep every decim-th output (decimating FIR).
      method: "auto" | "mxu" | "conv" | "fft" | "mxu3" (see the module
        docstring). "auto" follows the reference: "fft" above 384 taps,
        "mxu" for host taps with decim <= max(4, ntaps // 8), else "conv".
        Tensor taps take "conv" in place of "mxu" (the tap matrix is built
        from host taps).
      dev_taps: ``fir_taps(taps, B // decim, decim, x.device, method,
        x.is_complex(), fft_method, fft_size)`` for host taps; built here
        when None.
      fft_method, fft_size: the "fft" method's engine ("auto" | "xla" |
        "mxu", ``fft_engine``) and segment size (None: the reference's
        adaptive rule).

    Returns (new_state, y) with y of length B // decim along the last axis.
    """
    taps_static = not isinstance(taps, torch.Tensor)
    taps_np = np.asarray(taps) if taps_static else None
    ntaps = int(len(taps_np) if taps_static else taps.shape[0])
    method = _resolve_method(method, ntaps, taps_static, decim)
    B = int(x.shape[-1])
    if B % decim != 0:
        raise ValueError(f"batch size {B} not divisible by decimation {decim}")
    n_out = B // decim
    xfull = torch.cat([state.tail, x], -1) if ntaps > 1 else x
    if taps_static and (
            dev_taps is None
            or (method == "mxu" and dev_taps.toeplitz is None)
            or (method == "fft" and (dev_taps.fft is None
                                     or dev_taps.fft.complex_stream
                                     != (x.is_complex()
                                         or np.iscomplexobj(taps_np))))):
        dev_taps = fir_taps(taps_np, n_out, decim, x.device, method,
                            x.is_complex(), fft_method, fft_size)
    if method == "fft":
        y = fft_filter_full(xfull, taps_np if taps_static else taps, n_out,
                            decim, fft_size, fft_method, taps_np,
                            dev_taps.fft if taps_static else None)
    elif method == "mxu":
        y = _mxu_fir(xfull, dev_taps.toeplitz, n_out, decim)
    else:
        rev = dev_taps.rev if taps_static else taps.flip(0)
        y = _conv1d(xfull, rev, stride=decim)[..., :n_out]
    new_tail = xfull[..., -(ntaps - 1):].clone() if ntaps > 1 else state.tail
    return FirState(tail=new_tail), y


class InterpTaps(NamedTuple):
    """The per-phase reversed taps of ``fir_interp_filter`` on a device
    (``interp_taps``): phase r's taps[l*interp + p], p = r*decim % interp."""

    phases: tuple


def interp_taps(taps, interp: int, decim: int, device) -> InterpTaps:
    taps = np.asarray(taps)
    dtype = np.complex64 if np.iscomplexobj(taps) else np.float32
    L = -(-len(taps) // interp)  # taps per phase, zero-padded
    tpad = np.pad(taps, (0, L * interp - len(taps)))
    # a copy: a one-tap arm's reversed view keeps its negative stride
    return InterpTaps(tuple(
        torch.tensor(np.array(tpad[(r * decim) % interp::interp][::-1], dtype),
                     device=device)
        for r in range(interp)))


def fir_interp_filter(taps, state: FirState, x: torch.Tensor, interp: int,
                      decim: int = 1, dev_taps=None):
    """Polyphase rational resampling FIR along the last axis: upsample by
    ``interp``, filter, keep every ``decim``-th output (scipy.signal.upfirdn
    semantics, streaming; reference ``ops/fir.py`` ``fir_interp_filter``).

        y[m] = sum_t taps[t] * xu[m*decim - t],  xu the zero-stuffed input

    The state carries ceil((ntaps-1)/interp) raw input samples
    (``resampler_init_state``). Output length B * interp // decim.

    interp == 1 is the decimating ``fir_filter`` (the state contracts
    coincide; ``dev_taps`` is then its ``FirTaps``). For interp > 1, output
    phase r = m mod interp is a decimate-by-``decim`` correlation of the RAW
    input with the tap subset taps[l*interp + p], p = r*decim mod interp,
    ending at raw sample hist + (r*decim - p)/interp (the reference's
    derivation); ``dev_taps`` is then ``interp_taps(...)``.
    """
    if interp == 1:
        return fir_filter(taps, state, x, decim=decim, method="auto",
                          dev_taps=dev_taps)
    taps = np.asarray(taps)
    ntaps = len(taps)
    B = int(x.shape[-1])
    if (B * interp) % decim != 0:
        raise ValueError(f"B*interp ({B}*{interp}) not divisible by decim {decim}")
    if dev_taps is None:
        dev_taps = interp_taps(taps, interp, decim, x.device)
    n_out = B * interp // decim
    hist = int(state.tail.shape[-1])  # raw-domain history samples
    xfull = torch.cat([state.tail, x], -1)
    L = -(-ntaps // interp)
    nmax = -(-n_out // interp)  # outputs per phase (the last may be cut)
    phases = []
    for r in range(interp):
        p = (r * decim) % interp
        o_r = hist + (r * decim - p) // interp
        start, stop = o_r - (L - 1), o_r + (nmax - 1) * decim + 1
        pad = max(0, stop - int(xfull.shape[-1]))
        src = (torch.cat([xfull, xfull.new_zeros((*xfull.shape[:-1], pad))], -1)
               if pad else xfull)
        phases.append(_conv1d(src[..., start:stop], dev_taps.phases[r],
                              stride=decim)[..., :nmax])
    y = torch.stack(phases, -1).reshape(*x.shape[:-1], -1)[..., :n_out]
    new_tail = xfull[..., -hist:].clone() if hist > 0 else state.tail
    return FirState(tail=new_tail), y


def resampler_init_state(ntaps: int, interp: int, device,
                         dtype=torch.complex64) -> FirState:
    """History of ceil((ntaps-1)/interp) raw samples."""
    hist = -(-(ntaps - 1) // interp) if ntaps > 1 else 0
    return FirState(tail=torch.zeros((hist,), dtype=dtype, device=device))
