"""Analog blocks (reference: newsched_tpu/blocks/analog.py): the noise
source of the staged flagship; the tone sources, the quadrature demod,
the FM de- and pre-emphasis and the fused and live wideband-FM receivers
of config #1; the live filtered tone of config #0; the AGC.

Every piece of stream state is a tensor on the run's device: the NCO
phases (int64 holding the uint32 value), the noise group counter (int64)
and the live sources' first-batch flag (bool). The kernels read them from
the card and each step advances them there, so no step reads a value back
and the runner's captured graph of a chunk of steps replays the stream on
(runtime/runner.py). The ``dphase`` parameters are int64 tensors as well.

The receiver's fused and live blocks and the live filtered tone shard over
a mesh's time axis (``work_sharded``, run by the compiler under
``fg.run(mesh=...)``): each time shard runs the block's kernel on its own
stretch of the batch. The live blocks need no collective, since a window
of theirs is a pure function of the phase counter: the kernel of shard d
starts at phase ph + dphase * n_loc * d (uint32 arithmetic on the card),
and only shard 0 of the stream's first batch has samples before the
stream. On a process mesh (parallel/mesh.py ``make_process_mesh``) a
rank runs its own n_local shards, global shards [r n_local, (r+1)
n_local), and returns their output, its part of the reference's
``P(axis)`` output; a stream position still advances by the global
batch.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from newsched_tpu_torch.blocks import filter as filt
from newsched_tpu_torch.ops import agc as agc_ops, analog as analog_ops, \
    firdes, iir as iir_ops, nco
from newsched_tpu_torch.ops.cuda import (fir_source, fm_chain, noise, sources,
                                         wbfm_chain)
from newsched_tpu_torch.parallel.halo import broadcast, time_halo
from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.utils.dtypes import port_dtype

_WIDTH = 128  # stream words per generated row, as the reference's kernel


class noise_source(Block):
    """Gaussian noise (reference analog::noise_source<T>), cf32 or rf32.

    The stream is ops/cuda/noise.py's position-pure Philox + Irwin-Hall
    stream (the CUDA kernel on a GPU, its bit-identical plain version on
    the CPU), generated as rows of 128 float32 words, as the reference's
    hardware-PRNG engine does: rf32 reads the rows in order; cf32 takes
    each row's first 64 words as real parts and the last 64 as imaginary
    parts. Each of I/Q is a full-amplitude draw. Deterministic in (seed,
    absolute 64-row group), so a batch's word count (2 per cf32 item)
    must be a multiple of 64 * 128 = 8192.

    Method names: "auto" and "pallas" select this stream (the reference's
    "pallas" is its TPU-hardware stream, which this one replaces).
    "threefry" and uniform noise raise: their bits come from jax.random's
    key chaining, which the port does not reproduce.
    """

    def __init__(self, noise_type: str = "gaussian", amplitude: float = 1.0,
                 seed: int = 0, dtype="cf32", method: str = "auto", name=None):
        super().__init__(name)
        if method == "threefry":
            raise NotImplementedError(
                "noise_source(method='threefry'): jax.random's key chaining "
                "has no port; use 'auto' (position-pure Philox)")
        if method not in ("auto", "pallas"):
            raise ValueError(f"method {method!r} not in auto/pallas/threefry")
        if noise_type != "gaussian":
            raise NotImplementedError(
                f"noise_source({noise_type!r}): the reference draws "
                "non-gaussian noise from jax.random (threefry), which has no "
                "port; gaussian noise comes from the Philox stream")
        self.dtype = port_dtype(dtype)
        if self.dtype.name not in ("cf32", "rf32"):
            raise NotImplementedError(
                f"noise_source dtype {self.dtype.name}: the Philox stream "
                "emits cf32 or rf32")
        self.noise_type = noise_type
        self.seed = int(seed)
        self.method = method
        self.add_output("out", self.dtype)
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def _words(self, nout: int) -> int:
        return nout * (2 if self.dtype.name == "cf32" else 1)

    def init_state(self, nin, nout, device):
        if self._words(nout) % (noise.GROUP_ROWS * _WIDTH):
            raise ValueError(
                f"noise_source needs batches whose f32 word count is a "
                f"multiple of {noise.GROUP_ROWS * _WIDTH}, got "
                f"{self._words(nout)} ({nout} {self.dtype.name} items)")
        return {"group": noise.group_tensor(0, device)}

    def work(self, state, ins, params, nout):
        a = params["amplitude"]
        n_rows = self._words(nout) // _WIDTH
        cf32 = self.dtype.name == "cf32"
        r = noise.gaussian_rows(state["group"], n_rows=n_rows, width=_WIDTH,
                                seed=self.seed, device=a.device, amp=a,
                                layout="cf32" if cf32 else "rows")
        group = noise.advance(state["group"], n_rows // noise.GROUP_ROWS)
        return {"group": group}, {"out": r.reshape(-1)}


class sig_source(Block):
    """Tone/waveform source (reference analog::sig_source<T>): sin, cos,
    complex exponential, square, triangle, sawtooth at exact NCO phase.

    frequency/amplitude/offset are runtime-settable parameters; waveform and
    dtype are fixed at construction. complex, cos and sin come from the NCO
    kernel (ops/cuda/sources.py ``nco_planes``, K8; its plain version on the
    CPU); square, triangle and saw are torch ops on the NCO phase, as in the
    reference. The phase counter and ``dphase`` are int64 tensors on the
    run's device, so a step reads nothing back from the card.
    """

    WAVEFORMS = ("cos", "sin", "complex", "square", "triangle", "saw")

    def __init__(self, sampling_freq: float, waveform: str = "complex",
                 frequency: float = 1000.0, amplitude: float = 1.0,
                 offset: float = 0.0, dtype="cf32", name=None):
        super().__init__(name)
        if waveform not in self.WAVEFORMS:
            raise ValueError(f"waveform {waveform!r} not in {self.WAVEFORMS}")
        self.waveform = waveform
        self.sampling_freq = float(sampling_freq)
        d = port_dtype(dtype)
        self.dtype = d
        self.add_output("out", d)
        self.declare_param("dphase", nco.freq_to_dphase(frequency, sampling_freq),
                           dtype=None, doc="per-sample phase increment")
        self.declare_param("amplitude", amplitude, dtype=np.float32)
        self.declare_param("offset", offset,
                           dtype=d.np_dtype if d.name != "cf32" else np.complex64)

    def set_frequency(self, freq: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(freq, self.sampling_freq))

    def init_state(self, nin, nout, device):
        return {"phase": nco.phase_tensor(0, device)}

    def work(self, state, ins, params, nout):
        ph0, dp = state["phase"], params["dphase"]
        a = params["amplitude"]
        dev = a.device
        if self.waveform in ("complex", "cos", "sin"):
            re, im = sources.nco_planes(ph0, dp, a, nout, dev)
            if self.waveform == "complex":
                y = torch.complex(re, im) + params["offset"]
            else:
                y = (re if self.waveform == "cos" else im) + params["offset"]
        else:
            phase = nco.nco_phase(ph0, dp, nout, dev)
            if self.waveform == "square":
                y = torch.where(phase < np.pi, a, -a)
            elif self.waveform == "triangle":
                y = a * (4 * torch.abs(phase / (2 * np.pi) - 0.5) - 1.0)
            else:  # saw
                y = a * (phase / np.pi - 1.0)
            y = y + params["offset"]
        return ({"phase": nco.nco_advance(ph0, dp, nout)},
                {"out": y.to(self.dtype.torch_dtype)})


class quadrature_demod(Block):
    """FM discriminator (reference analog::quadrature_demod): cf32 -> rf32,
    y[n] = gain * arg(conj(x[n-1]) x[n])."""

    def __init__(self, gain: float = 1.0, name=None):
        super().__init__(name)
        self.add_input("in", "cf32")
        self.add_output("out", "rf32")
        self.declare_param("gain", gain, dtype=np.float32)

    def init_state(self, nin, nout, device):
        return analog_ops.quad_demod_init_state(device)

    def work(self, state, ins, params, nout):
        st, y = analog_ops.quadrature_demod(state, ins["in"], params["gain"])
        return st, {"out": y}


class agc(Block):
    """AGC (reference analog::agc_cc/_ff): ops/agc.py's affine scan (S5 on
    the card, its workspace kept per device and batch length);
    ``rate`` and ``reference`` settable, ``max_gain`` <= 0 no clamp."""

    def __init__(self, rate: float = 1e-4, reference: float = 1.0,
                 gain: float = 1.0, max_gain: float = 0.0, dtype="cf32",
                 name=None):
        super().__init__(name)
        d = port_dtype(dtype)
        self.add_input("in", d)
        self.add_output("out", d)
        self.initial_gain = gain
        self.max_gain = max_gain
        self.declare_param("rate", rate, dtype=np.float32)
        self.declare_param("reference", reference, dtype=np.float32)
        self._ws: dict[tuple, agc_ops.kscan.AgcWorkspace] = {}

    def init_state(self, nin, nout, device):
        return agc_ops.agc_init_state(self.initial_gain, device)

    def work(self, state, ins, params, nout):
        x, ws = ins["in"], None
        if x.device.type == "cuda":
            key = (x.device, int(x.shape[-1]))
            if key not in self._ws:
                self._ws[key] = agc_ops.kscan.agc_workspace(key[1], x.device)
            ws = self._ws[key]
        st, y = agc_ops.agc(state, x, params["rate"], params["reference"],
                            self.max_gain, workspace=ws)
        return st, {"out": y}


def _emphasis_taps(fs: float, tau: float, fh: float | None, deemph: bool):
    """Single-pole emphasis-network taps via the bilinear transform
    (the GR-lineage fm_deemph/fm_preemph hier blocks): corner at 1/tau
    rad/s, prewarped; the pre-emphasis network adds an upper corner fh
    (default 0.925 * fs/2) so its gain stops rising near Nyquist. Returns
    (b, a) for ops/iir.py ``lfilter_taps``."""
    import math

    w_cl = 1.0 / tau
    w_cla = 2.0 * fs * math.tan(w_cl / (2.0 * fs))
    if deemph:
        k = -w_cla / (2.0 * fs)
        p1 = (1.0 + k) / (1.0 - k)
        b0 = -k / (1.0 - k)
        return np.array([b0, b0], np.float64), np.array([1.0, -p1], np.float64)
    # clamp as the GR reference does: fh at or above Nyquist puts the pole
    # on or beyond the unit circle (tan singular or negative)
    if fh is None or fh <= 0.0 or fh >= fs / 2.0:
        fh = 0.925 * fs / 2.0
    w_ch = 2.0 * math.pi * fh
    w_cha = 2.0 * fs * math.tan(w_ch / (2.0 * fs))
    kl = -w_cla / (2.0 * fs)
    kh = -w_cha / (2.0 * fs)
    z1 = (1.0 + kl) / (1.0 - kl)
    p1 = (1.0 + kh) / (1.0 - kh)
    b0 = (1.0 - kl) / (1.0 - kh)
    return np.array([b0, -z1 * b0], np.float64), np.array([1.0, -p1], np.float64)


class fm_deemph(filt.iir_filter):
    """FM broadcast de-emphasis (GR-lineage analog fm_deemph): a
    single-pole IIR low-pass, corner 1/tau (75 us US, 50 us EU), run as
    ``filter.iir_filter`` (ops/iir.py: S4 on the card)."""

    def __init__(self, fs: float, tau: float = 75e-6, name=None):
        b, a = _emphasis_taps(fs, tau, None, deemph=True)
        super().__init__(*iir_ops.lfilter_taps(b, a), dtype="rf32", name=name)


class fm_preemph(filt.iir_filter):
    """FM broadcast pre-emphasis (GR-lineage analog fm_preemph): one zero
    at the 1/tau corner, one pole at fh (default 0.925 * Nyquist)."""

    def __init__(self, fs: float, tau: float = 75e-6, fh: float = -1.0,
                 name=None):
        b, a = _emphasis_taps(fs, tau, fh if fh > 0 else None, deemph=False)
        super().__init__(*iir_ops.lfilter_taps(b, a), dtype="rf32", name=name)


class _wbfm_chain_block(Block):
    """What the fused and live wideband-FM blocks share: the chain's plan
    (rotated taps, demod rotation, resampler taps, junction sizes), its
    constants uploaded once per device, and the ``center_freq`` fence
    parameter, whose hook rebuilds both."""

    def __init__(self, chan_taps, center_freq: float, fs: float, decim: int,
                 deviation: float, resamp_interp: int, resamp_decim: int,
                 resamp_taps, tile, precision, name):
        super().__init__(name)
        if resamp_interp != 1:
            raise NotImplementedError(
                f"{type(self).__name__} fuses interp-1 resamplers only; use "
                f"the staged wbfm_receiver for rational interpolation")
        if precision not in fm_chain.PRECISIONS:
            raise ValueError(f"precision {precision!r} not in "
                             f"{fm_chain.PRECISIONS}")
        if resamp_taps is None:
            cutoff = 0.45 / max(resamp_interp, resamp_decim)
            trans = 0.1 / max(resamp_interp, resamp_decim)
            resamp_taps = firdes.low_pass(resamp_interp, 1.0, cutoff, trans)
        quad_rate = fs / decim
        self._plan_args = (np.asarray(chan_taps), float(fs), int(decim),
                           np.asarray(resamp_taps), int(resamp_decim),
                           float(quad_rate / (2 * np.pi * deviation)),
                           precision)
        self.sampling_freq = float(fs)
        self.tile = tile
        self._consts: dict[torch.device, wbfm_chain.WbfmConsts] = {}
        self.plan = self._build_plan(center_freq)
        # A RECOMPILE-FENCE parameter, as in the reference: the rotated
        # taps bake center_freq in, so setting it rebuilds the plan and its
        # device constants before the next batch. The junction state is raw
        # input rows, so the retuned chain re-locks without a glitch.
        self.declare_param("center_freq", float(center_freq), dtype=None,
                           fence=True)

    def _build_plan(self, center_freq: float) -> wbfm_chain.WbfmChainPlan:
        chan_taps, fs, decim, rt, rd, gain, precision = self._plan_args
        return wbfm_chain.WbfmChainPlan(
            chan_taps, nco.freq_to_dphase(center_freq, fs), decim, rt, rd,
            demod_gain=gain, precision=precision)

    def on_fence_param(self, name, value):
        # B8 depends only on the tap counts: the carry's shape survives
        self.plan = self._build_plan(float(value))
        self._consts = {}

    def consts(self, device) -> wbfm_chain.WbfmConsts:
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = wbfm_chain.wbfm_consts(self.plan, device)
        return self._consts[device]


class wbfm_rcv_fused(_wbfm_chain_block):
    """The wideband-FM receive chain (BASELINE config #1: freq_xlating_fir
    -> quadrature_demod -> rational_resampler) as ONE kernel on the
    time-folded-lanes layout (ops/cuda/wbfm_chain.py, K10): cf32 stream in
    -> rf32 audio at rate 1/(decim*resamp_decim).

    A drop-in for the staged chain of models.wbfm_receiver, to float32
    accuracy (the dropped output NCO is an exact identity through the
    demod). As in the reference, center_freq is a fence parameter (setting
    it rebuilds the rotated taps), interp-1 resamplers only, and batches
    are multiples of 64*decim*resamp_decim samples, at least plan.B8 * 64.

    input_format="folded" takes the folded rows themselves (rf32[(128,)]
    items of 64 samples each, as ``sig_source_folded`` emits them): no
    complex assembly and no fold transpose.
    """

    def __init__(self, chan_taps, center_freq: float, fs: float,
                 decim: int = 4, deviation: float = 75e3,
                 resamp_interp: int = 1, resamp_decim: int = 5,
                 resamp_taps=None, tile: int | None = None,
                 precision="split3", input_format: str = "cf32", name=None):
        super().__init__(chan_taps, center_freq, fs, decim, deviation,
                         resamp_interp, resamp_decim, resamp_taps, tile,
                         precision, name)
        if input_format not in ("cf32", "folded"):
            raise ValueError(f"input_format {input_format!r} not in "
                             f"cf32/folded")
        self.input_format = input_format
        S = wbfm_chain.S
        if input_format == "folded":
            self.relative_rate = Fraction(S, decim * resamp_decim)
            self.in_multiple = decim * resamp_decim
            self.add_input("in", "rf32", item_shape=(2 * S,))
        else:
            self.relative_rate = Fraction(1, decim * resamp_decim)
            self.in_multiple = S * decim * resamp_decim
            self.add_input("in", "cf32")
        self.add_output("out", "rf32")

    def init_state(self, nin, nout, device):
        return {"carry": torch.zeros((self.plan.B8, 2 * wbfm_chain.S),
                                     dtype=torch.float32, device=device)}

    def work(self, state, ins, params, nout):
        x = ins["in"]
        xp = (x.contiguous() if self.input_format == "folded"
              else wbfm_chain.fold_planes(x))
        aud, carry = wbfm_chain.wbfm_chain_step(
            xp, state["carry"], self.plan, self.consts(x.device),
            tile=self.tile)
        return {"carry": carry}, {"out": wbfm_chain.unfold_audio(aud)}

    def init_state_sharded(self, nin, nout, mesh, axis):
        return self.init_state(nin, nout, mesh.device)

    def work_sharded(self, state, ins, params, nout, mesh, axis):
        """Each time shard's segment folded on its own (one op for all),
        then K10 over every shard in one launch: shard d's junction is the
        B8 boundary rows of its left neighbour's fold (shard 0: the carry),
        and the new carry the last shard's. On a process mesh ``in`` is
        the rank's own segment, its n_local shards: the junction of rank
        r > 0's first shard is rank r-1's last B8 fold rows (``time_halo``'s
        ring), rank 0's the carry, and the new carry the last rank's last
        B8 rows on every rank (``broadcast``, the reference's ``psum``)."""
        if self.input_format == "folded":
            raise NotImplementedError(
                "wbfm_rcv_fused(input_format='folded') has per-batch fold "
                "semantics and does not shard; use input_format='cf32' "
                "under fg.run(mesh=...)")
        nd = mesh.local(axis)
        x = ins["in"]
        xp = wbfm_chain.fold_planes(x, nd)
        junction = (state["carry"] if mesh.world == 1 else
                    time_halo([xp], [state["carry"]], mesh)[0][0])
        aud, carry = wbfm_chain.wbfm_chain_step(
            xp, junction, self.plan, self.consts(x.device), tile=self.tile,
            nd=nd)
        if mesh.world > 1:
            carry = broadcast(carry, mesh.world - 1, mesh)
        # the reference's psum of the last shard's boundary rows, the one
        # contributor
        return {"carry": carry}, {"out": wbfm_chain.unfold_audio(aud, nd)}


class sig_source_folded(Block):
    """Tone source emitting the time-folded-lanes rows of the fused
    wideband-FM chain: rf32[(128,)] rows, a batch of R rows carrying 64*R
    consecutive samples, segment s of the batch in lanes (s, 64+s). The
    partner of wbfm_rcv_fused(input_format="folded"); the NCO kernel
    ``nco_folded`` (K11) writes the layout directly. The fold is per batch,
    so it only makes sense feeding a folded-input block at the same batch
    size (models.wbfm_receiver wires it)."""

    def __init__(self, sampling_freq: float, frequency: float = 1000.0,
                 amplitude: float = 1.0, name=None):
        super().__init__(name)
        self.sampling_freq = float(sampling_freq)
        self.add_output("out", "rf32", item_shape=(2 * sources.S,))
        self.declare_param("dphase", nco.freq_to_dphase(frequency, sampling_freq),
                           dtype=None)
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def set_frequency(self, freq: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(freq, self.sampling_freq))

    def init_state(self, nin, nout, device):
        return {"phase": nco.phase_tensor(0, device)}

    def init_state_sharded(self, nin, nout, mesh, axis):
        # the folded layout is per batch (segment s of THIS batch in lane
        # s), so a time shard of the row stream is not one of the samples
        raise ValueError(
            f"{type(self).__name__} does not shard under fg.run(mesh=...): "
            "its folded rows have per-batch semantics. Use wbfm_live_source "
            "(which shards itself) or the cf32 sig_source path")

    def work(self, state, ins, params, nout):
        a = params["amplitude"]
        out = sources.nco_folded(state["phase"], params["dphase"], a, nout,
                                 a.device)
        return ({"phase": nco.nco_advance(state["phase"], params["dphase"],
                                          sources.S * int(nout))},
                {"out": out})


class wbfm_live_source(_wbfm_chain_block):
    """The LIVE wideband-FM receiver as ONE source kernel: the NCO test tone
    is generated inside the fused chain (ops/cuda/wbfm_chain.py
    ``wbfm_chain_live_step``, K12), so the only stream state is the phase
    counter and a first-batch flag (samples before the stream are 0), both
    on the card.
    Emits the rf32 audio stream; bit-identical to ``sig_source_folded ->
    wbfm_rcv_fused(input_format="folded")`` with the same parameters."""

    def __init__(self, chan_taps, center_freq: float, fs: float,
                 decim: int = 4, deviation: float = 75e3,
                 resamp_interp: int = 1, resamp_decim: int = 5,
                 resamp_taps=None, frequency: float = 0.0,
                 amplitude: float = 1.0, tile: int | None = None,
                 precision="split3", name=None):
        super().__init__(chan_taps, center_freq, fs, decim, deviation,
                         resamp_interp, resamp_decim, resamp_taps, tile,
                         precision, name)
        self.add_output("out", "rf32")
        self.declare_param("dphase", nco.freq_to_dphase(frequency, fs),
                           dtype=None, doc="tone phase increment")
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def set_frequency(self, freq: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(freq, self.sampling_freq))

    def init_state(self, nin, nout, device):
        return _live_state(device)

    def work(self, state, ins, params, nout):
        S, D, Rd = wbfm_chain.S, self.plan.D, self.plan.Rd
        if (int(nout) * D * Rd) % S:
            raise ValueError(f"audio batch {nout} not a multiple of "
                             f"{S // np.gcd(S, D * Rd)} items (fold width)")
        R = int(nout) * D * Rd // S
        a = params["amplitude"]
        aud = wbfm_chain.wbfm_chain_live_step(
            state["phase"], params["dphase"], a, state["first"], self.plan,
            self.consts(a.device), R, tile=self.tile)
        return (_live_advance(state, params["dphase"], S * R),
                {"out": wbfm_chain.unfold_audio(aud)})

    def init_state_sharded(self, nin, nout, mesh, axis):
        S, D, Rd = wbfm_chain.S, self.plan.D, self.plan.Rd
        nd = mesh.shape[axis]
        total = int(nout) * D * Rd
        if total % (nd * S) or int(nout) % nd:
            raise ValueError(
                f"{self.name}: batch of {nout} audio items does not split "
                f"over mesh time axis {nd} in fold-width units")
        if (total // nd) // S < self.plan.B8:
            raise ValueError(
                f"{self.name}: per-device fold {(total // nd) // S} rows < "
                f"boundary {self.plan.B8} rows — use a larger batch")
        return self.init_state(nin, nout, mesh.device)

    def work_sharded(self, state, ins, params, nout, mesh, axis):
        """K12 over every time shard of this process in one launch, each
        at its own phase offset (the kernel's shard index, from its grid):
        zero collectives. ``nout``: the global batch."""
        n = mesh.local(axis)
        S, D, Rd = wbfm_chain.S, self.plan.D, self.plan.Rd
        n_loc = int(nout) * D * Rd // mesh.shape[axis]  # samples a shard
        ph, dp, a = state["phase"], params["dphase"], params["amplitude"]
        aud = wbfm_chain.wbfm_chain_live_step(
            ph, dp, a, state["first"], self.plan, self.consts(a.device),
            n_loc // S, tile=self.tile, shard=mesh.rank * n, nd=n)
        return (_live_advance(state, dp, int(nout) * D * Rd),
                {"out": wbfm_chain.unfold_audio(aud, n)})


class fir_tone_source(Block):
    """Config #0's whole chain as ONE source kernel: the fixed-point NCO
    tone generated and FIR-filtered (and decimated) in the same pass
    (ops/cuda/fir_source.py ``fir_tone_step``, K9). Emits the filtered cf32
    stream; real taps only (each re and im plane is filtered on its own).
    A FIR has no recursive state, so the only stream state is the phase
    counter and a first-batch flag (samples before the stream are 0), on
    the card as in ``wbfm_live_source``. Equal to ``sig_source ->
    fir_filter(decim)`` to float32 accuracy. Batches are multiples of 64
    samples (64*decim, so that each segment decimates whole)."""

    def __init__(self, sampling_freq: float, taps, frequency: float = 0.0,
                 amplitude: float = 1.0, decim: int = 1,
                 tile: int | None = None, name=None):
        super().__init__(name)
        taps = np.asarray(taps)
        if np.iscomplexobj(taps):
            raise ValueError("fir_tone_source: real taps only")
        self.taps = taps.astype(np.float32)
        self.decim = int(decim)
        self.sampling_freq = float(sampling_freq)
        self.tile = tile
        self.add_output("out", "cf32")
        self.declare_param("dphase", nco.freq_to_dphase(frequency, sampling_freq),
                           dtype=None, doc="tone phase increment")
        self.declare_param("amplitude", amplitude, dtype=np.float32)
        self._consts: dict[torch.device, fir_source.FirToneConsts] = {}

    def set_frequency(self, freq: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(freq, self.sampling_freq))

    def dev_taps(self, device) -> fir_source.FirToneConsts:
        """The taps and the kernel's FFT table on ``device``, made once."""
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = fir_source.fir_tone_consts(self.taps, device)
        return self._consts[device]

    def _fold_rows(self, nout: int) -> int:
        n_samp = int(nout) * self.decim
        if n_samp % fir_source.S:
            raise ValueError(f"{self.name}: batch of {nout} output items "
                             f"({n_samp} samples) not a multiple of the "
                             f"fold width ({fir_source.S} samples)")
        return n_samp // fir_source.S

    def init_state(self, nin, nout, device):
        return _live_state(device)

    def work(self, state, ins, params, nout):
        R = self._fold_rows(nout)
        a = params["amplitude"]
        out = fir_source.fir_tone_step(state["phase"], params["dphase"], a,
                                       state["first"], self.dev_taps(a.device),
                                       self.decim, R, tile=self.tile)
        return (_live_advance(state, params["dphase"], fir_source.S * R),
                {"out": fir_source.unfold_complex(out)})

    def init_state_sharded(self, nin, nout, mesh, axis):
        nd = mesh.shape[axis]
        if int(nout) % nd:
            raise ValueError(f"{self.name}: batch {nout} does not split "
                             f"over mesh time axis {nd}")
        self._fold_rows(int(nout) // nd)  # per-device geometry check
        return self.init_state(nin, nout, mesh.device)

    def work_sharded(self, state, ins, params, nout, mesh, axis):
        """K9 over every time shard of this process in one launch, each at
        its own phase offset (the kernel's shard index, from its grid) and
        with its own transform alignment: zero collectives. ``nout``: the
        global batch."""
        n = mesh.local(axis)
        R_loc = self._fold_rows(int(nout) // mesh.shape[axis])
        ph, dp, a = state["phase"], params["dphase"], params["amplitude"]
        out = fir_source.fir_tone_step(
            ph, dp, a, state["first"], self.dev_taps(a.device), self.decim,
            R_loc, tile=self.tile, shard=mesh.rank * n, nd=n)
        return (_live_advance(state, dp, int(nout) * self.decim),
                {"out": fir_source.unfold_complex(out, n)})


def _live_state(device) -> dict:
    """The live sources' stream state on ``device``: the phase counter and
    the first-batch flag."""
    return {"phase": nco.phase_tensor(0, device),
            "first": torch.ones((), dtype=torch.bool, device=device)}


def _live_advance(state: dict, dphase, n: int) -> dict:
    """The live sources' state after a batch of n samples, on the card."""
    return {"phase": nco.nco_advance(state["phase"], dphase, n),
            "first": torch.zeros_like(state["first"])}
