"""Vector-stream DSP blocks (reference: newsched_tpu/blocks/vector_dsp.py):
the per-channel demod and audio filter of the staged flagship, the
planes-rows source and adapter, the fused channelizer block, and the live
flagship's generating source.

As in the reference, one block processes all M channels as one batched
kernel: the per-channel axis is the kernel's lane axis. The two fused
blocks also shard over a mesh's time axis (``work_sharded``, run by the
compiler under ``fg.run(mesh=...)``).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from newsched_tpu_torch.ops import fir as fir_ops, firdes, pfb as pfb_ops
from newsched_tpu_torch.ops.cuda import fm_chain, noise
from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.utils.dtypes import port_dtype


class vector_quad_demod(Block):
    """Quadrature/FM demod applied per channel on (M,)-vector items:
    cf32[(M,)] -> rf32[(M,)]."""

    def __init__(self, nchans: int, gain: float = 1.0, name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.add_input("in", "cf32", item_shape=(self.nchans,))
        self.add_output("out", "rf32", item_shape=(self.nchans,))
        self.declare_param("gain", gain, dtype=np.float32)

    def init_state(self, nin, nout, device):
        return {"prev": torch.zeros((self.nchans,), dtype=torch.complex64,
                                    device=device)}

    def work(self, state, ins, params, nout):
        x = ins["in"]  # (n, M)
        xprev = torch.cat([state["prev"][None, :], x[:-1]])
        p = torch.conj(xprev) * x
        # Zero-history convention: pinned to exactly 0, as in every other
        # demod path (the fused kernels, the float64 golden).
        y = torch.where((xprev == 0) | (x == 0), torch.zeros((), device=x.device),
                        torch.atan2(p.imag, p.real)) * params["gain"]
        return {"prev": x[-1].clone()}, {"out": y.to(torch.float32)}


class vector_fir(Block):
    """Shared-taps FIR (+decimation) applied per channel on vector items:
    the audio filter stage of a channelized receiver. State is a
    per-channel tail; all M channels are filtered in one batched product
    (ops/fir.py works along the last axis)."""

    def __init__(self, nchans: int, taps, decim: int = 1, dtype="rf32",
                 method: str = "auto", name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.method = method
        self.relative_rate = Fraction(1, self.decim)
        self.dtype = port_dtype(dtype)
        self.add_input("in", self.dtype, item_shape=(self.nchans,))
        self.add_output("out", self.dtype, item_shape=(self.nchans,))
        self._dev_taps: dict[tuple, fir_ops.FirTaps] = {}

    def init_state(self, nin, nout, device):
        return fir_ops.fir_init_state(len(self.taps), device,
                                      self.dtype.torch_dtype, (self.nchans,))

    def work(self, state, ins, params, nout):
        x = ins["in"].T
        key = (x.device, nout)  # the taps on the device, once per batch shape
        if key not in self._dev_taps:
            self._dev_taps[key] = fir_ops.fir_taps(self.taps, nout, self.decim,
                                                   x.device)
        st, y = fir_ops.fir_filter(self.taps, state, x, decim=self.decim,
                                   method=self.method,
                                   dev_taps=self._dev_taps[key])
        return st, {"out": y.T}


class channel_select(Block):
    """Pick one channel from a vector stream: cf32[(M,)] -> cf32 scalar
    items (utility for tests and single-channel taps off a channelizer)."""

    def __init__(self, nchans: int, channel: int, dtype="cf32", name=None):
        super().__init__(name)
        self.channel = int(channel)
        d = port_dtype(dtype)
        self.add_input("in", d, item_shape=(int(nchans),))
        self.add_output("out", d)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"][:, self.channel]}


class cplx_to_planes(Block):
    """Adapter: cf32 scalar stream -> the planes-rows stream format of the
    fused FM chain (ops/cuda/fm_chain.py): rf32[(2M,)] rows, row k =
    [re | im] of x[kM-(M-1) .. kM]. Carries the M-1-sample skew between
    batches."""

    def __init__(self, nchans: int, name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.relative_rate = Fraction(1, self.nchans)
        self.add_input("in", "cf32")
        self.add_output("out", "rf32", item_shape=(2 * self.nchans,))

    def init_state(self, nin, nout, device):
        return {"skew": torch.zeros((self.nchans - 1,), dtype=torch.complex64,
                                    device=device)}

    def work(self, state, ins, params, nout):
        M = self.nchans
        full = torch.cat([state["skew"], ins["in"]])
        rows = full[: nout * M].reshape(nout, M)
        planes = torch.cat([rows.real, rows.imag], dim=1).to(torch.float32)
        return {"skew": full[nout * M:]}, {"out": planes}


class noise_planes_source(Block):
    """Gaussian noise emitted directly in planes-rows format: the
    no-prep-pass producer for the fused FM chain (each lane is an i.i.d.
    draw, so the M-1-sample skew of the row convention is immaterial).

    The stream is ops/cuda/noise.py's position-pure Philox + Irwin-Hall
    stream on every device (the CUDA kernel on a GPU, its bit-identical
    plain version on the CPU), deterministic in (seed, absolute 64-row
    group): batches must be multiples of 64 rows. Method names:
    "auto" and "pallas" select it (the reference's "pallas" is its
    TPU-hardware stream, which this one replaces); "pure" is the
    reference's portable position-pure stream, which this one also
    replaces. "threefry" raises: its bits come from jax's key chaining,
    which the port does not reproduce.
    """

    def __init__(self, nchans: int, amplitude: float = 1.0, seed: int = 0,
                 method: str = "auto", name=None):
        super().__init__(name)
        if method == "threefry":
            raise NotImplementedError(
                "noise_planes_source(method='threefry'): jax.random's key "
                "chaining has no port; use 'auto' (position-pure Philox)")
        if method not in ("auto", "pallas", "pure"):
            raise ValueError(f"method {method!r} not in auto/pallas/pure")
        self.nchans = int(nchans)
        self.seed = int(seed)
        self.method = method
        self.add_output("out", "rf32", item_shape=(2 * self.nchans,))
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def init_state(self, nin, nout, device):
        if nout % noise.GROUP_ROWS:
            raise ValueError(
                f"noise_planes_source needs batches in multiples of "
                f"{noise.GROUP_ROWS} rows, got {nout}")
        return {"group": noise.group_tensor(0, device)}

    def work(self, state, ins, params, nout):
        amp = params["amplitude"]
        r = noise.gaussian_rows(state["group"], n_rows=nout,
                                width=2 * self.nchans, seed=self.seed,
                                device=amp.device, amp=amp)
        return ({"group": noise.advance(state["group"],
                                        nout // noise.GROUP_ROWS)},
                {"out": r})


class _fused_chain(Block):
    """What the two fused-chain blocks share: the chain's constants (fold
    taps from the prototype, audio taps, decimation, demod gain), uploaded
    once per device, and the chain's carried state."""

    def __init__(self, nchans: int, taps, audio_taps, audio_decim: int,
                 gain: float, taps_per_arm: int | None, precision, name):
        super().__init__(name)
        if precision not in fm_chain.PRECISIONS:
            raise ValueError(f"precision {precision!r} not in "
                             f"{fm_chain.PRECISIONS}")
        self.nchans = int(nchans)
        if taps is None:
            taps = firdes.prototype_channelizer_taps(self.nchans,
                                                     taps_per_arm or 16)
        self.arm = pfb_ops.pfb_arm_taps(np.asarray(taps, np.float32), self.nchans)
        self.fold_c = np.asarray(self.arm)[::-1, ::-1].T.copy()
        self.audio_taps = np.asarray(audio_taps, np.float32)
        self.audio_decim = int(audio_decim)
        self.gain = float(gain)
        self.precision = precision
        self.h8 = fm_chain._round8(self.arm.shape[1] - 1)
        self._consts: dict[torch.device, fm_chain.FmChainConsts] = {}

    def consts(self, device) -> fm_chain.FmChainConsts:
        """The chain constants on ``device``, uploaded once per device."""
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = fm_chain.fm_chain_consts(
                self.fold_c, self.audio_taps, device)
        return self._consts[device]

    def chain_state(self, device) -> dict:
        """Zero carried state: fold halo, last DFT row, audio tail."""
        M = self.nchans
        A = len(self.audio_taps)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return {"carry": z(self.h8, 2 * M), "prev": z(1, 2 * M),
                "atail": z(A - 1, 2 * M)}


class fm_channelizer_fused_planes(_fused_chain):
    """The flagship chain as ONE block on the planes-rows stream:
    rf32[(2M,)] rows in -> rf32[(M,)] audio out at rate 1/decim, backed by
    the fused kernel (ops/cuda/fm_chain.py fm_chain_step_planes). The
    stream format is the kernel's native format, so source -> this block
    -> sink runs no layout conversion at all."""

    def __init__(self, nchans: int, taps, audio_taps, audio_decim: int = 8,
                 gain: float = 1.0, taps_per_arm: int | None = None,
                 precision="split3", name=None):
        super().__init__(nchans, taps, audio_taps, audio_decim, gain,
                         taps_per_arm, precision, name)
        self.relative_rate = Fraction(1, self.audio_decim)
        self.add_input("in", "rf32", item_shape=(2 * self.nchans,))
        self.add_output("out", "rf32", item_shape=(self.nchans,))

    def init_state(self, nin, nout, device):
        return self.chain_state(device)

    def work(self, state, ins, params, nout):
        x = ins["in"].contiguous()  # (n, 2M) planes rows
        aud, prev, atail = fm_chain.fm_chain_step_planes(
            x, state["carry"], state["prev"], state["atail"],
            self.consts(x.device), self.audio_decim, self.gain,
            precision=self.precision)
        n = int(x.shape[0])
        carry = (x[-self.h8:] if n >= self.h8
                 else torch.cat([state["carry"], x])[-self.h8:]).clone()
        return {"carry": carry, "prev": prev, "atail": atail}, {"out": aud}

    # -- graph-level sharding: under fg.run(mesh=...) the block runs
    # parallel.channelizer.ShardedFMChannelizer.step_planes, K3 with warm >
    # 0 over every time shard in one launch, each shard's halo the warm +
    # H8 rows before it.

    def _sharded_pipe(self, mesh, axis):
        from newsched_tpu_torch.parallel.channelizer import ShardedFMChannelizer

        key = (id(mesh), axis)
        cache = getattr(self, "_sharded_cache", None)
        if cache is None or cache[0] != key:
            proto = np.asarray(self.arm).T.reshape(-1)  # inverse of pfb_arm_taps
            ch = ShardedFMChannelizer(
                mesh, self.nchans, proto, self.audio_taps,
                audio_decim=self.audio_decim, demod_gain=self.gain, axis=axis,
                chain_precision=self.precision)
            self._sharded_cache = (key, ch)
        return self._sharded_cache[1]

    def init_state_sharded(self, nin, nout, mesh, axis):
        st = self._sharded_pipe(mesh, axis).init_state_planes(nin)
        return {"carry": st.carry, "prev": st.prev, "atail": st.tail}

    def work_sharded(self, state, ins, params, nout, mesh, axis):
        from newsched_tpu_torch.parallel.channelizer import PlanesFMState

        st = PlanesFMState(carry=state["carry"], prev=state["prev"],
                           tail=state["atail"])
        aud, st2 = self._sharded_pipe(mesh, axis).step_planes(ins["in"], st)
        return ({"carry": st2.carry, "prev": st2.prev, "atail": st2.tail},
                {"out": aud})


class fm_noise_channelizer_source(_fused_chain):
    """The LIVE flagship as ONE source kernel: Gaussian noise generated
    inside the fused FM chain (ops/cuda/fm_chain.py fm_chain_gen_step,
    kernel K5) with no input stream at all. Emits rf32[(M,)] audio items;
    the noise stream is BIT-IDENTICAL to ``noise_planes_source(nchans,
    amplitude, seed)`` -> ``fm_channelizer_fused_planes`` with the same
    chain parameters, without that pipeline's 2 x 16.8 MB per-batch device
    memory round trip.

    ``generator``: "auto", "hw" and "pure" all select the port's one
    position-pure Philox stream (the reference's "hw" is its TPU-hardware
    stream and "pure" its portable twin; this stream replaces both).
    ``noise_draws``: Philox words per element, 3 (Irwin-Hall N=6, the
    default stream) or 2 (N=4: support +-3.46 sigma, excess kurtosis
    -0.3, a DIFFERENT stream). Batches must be multiples of 64 rows.
    """

    def __init__(self, nchans: int, taps, audio_taps, audio_decim: int = 8,
                 gain: float = 1.0, amplitude: float = 1.0, seed: int = 0,
                 taps_per_arm: int | None = None, precision="split3",
                 generator: str = "auto", noise_draws: int = 3, name=None):
        super().__init__(nchans, taps, audio_taps, audio_decim, gain,
                         taps_per_arm, precision, name)
        if generator not in ("auto", "hw", "pure"):
            raise ValueError(f"generator {generator!r} not in auto/hw/pure")
        if noise_draws not in noise.DRAWS:
            raise ValueError(f"noise_draws {noise_draws} not in {noise.DRAWS}")
        self.noise_draws = int(noise_draws)
        self.seed = int(seed)
        self.generator = generator
        self.add_output("out", "rf32", item_shape=(self.nchans,))
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def init_state(self, nin, nout, device):
        if (nout * self.audio_decim) % noise.GROUP_ROWS:
            raise ValueError(
                f"fm_noise_channelizer_source needs batches in multiples of "
                f"{noise.GROUP_ROWS} rows, got {nout * self.audio_decim}")
        return {"group": noise.group_tensor(0, device),
                **self.chain_state(device)}

    def work(self, state, ins, params, nout):
        n_loc = int(nout) * self.audio_decim
        amp = params["amplitude"]
        aud, prev, atail, carry = fm_chain.fm_chain_gen_step(
            state["group"], amp, state["carry"], state["prev"],
            state["atail"], self.consts(amp.device), self.audio_decim,
            self.gain, n_loc, seed=self.seed, draws=self.noise_draws)
        group = noise.advance(state["group"], n_loc // noise.GROUP_ROWS)
        return ({"group": group, "carry": carry, "prev": prev,
                 "atail": atail}, {"out": aud})

    # -- graph-level sharding: under fg.run(mesh=...) time shard d takes
    # its own absolute group range, base group + d * n_loc / 64, and
    # rebuilds its fold halo and junction from the stream itself: zero
    # collectives, and the only state is the 64-bit group counter. One K6
    # launch (fm_chain_gen_warm_step with nd shards) takes every shard: the
    # kernel adds each shard's offset to the counter it reads from the
    # card and writes the shards' audio in order.

    def _sharded_geometry(self, n_rows_tot: int, n_dev: int):
        """(rows a shard, the reference's tile and warm) for batches of
        n_rows_tot rows over n_dev shards; raises where the reference
        raises."""
        if n_rows_tot % n_dev:
            raise ValueError(
                f"{self.name}: batch rows {n_rows_tot} not divisible by "
                f"mesh time axis {n_dev}")
        n_loc = n_rows_tot // n_dev
        G = noise.GROUP_ROWS
        if n_loc % G:
            raise ValueError(
                f"{self.name}: per-device rows {n_loc} must be a multiple "
                f"of the noise group ({G} rows)")
        A = len(self.audio_taps)
        if self.h8 > G:
            raise ValueError(
                f"{self.name}: PFB halo {self.h8} rows exceeds one noise "
                f"group ({G}): sharded halo regeneration covers one group "
                f"(taps_per_arm <= {G + 1})")
        tile = fm_chain._pick_tile(n_loc, min(512, n_loc), self.audio_decim)
        if tile % G or tile < self.h8 or A - 1 > tile:
            raise ValueError(
                f"{self.name}: per-device rows {n_loc} give tile {tile}; "
                f"need a multiple of {G} with tile >= max(H8 {self.h8}, "
                f"A-1 {A - 1}) — use a larger batch")
        warm = tile
        if warm < -(-A // self.audio_decim) * self.audio_decim:
            raise ValueError(
                f"{self.name}: warm {warm} rows cannot rebuild the {A}-tap "
                f"audio state; use a larger batch")
        return n_loc, tile, warm

    def init_state_sharded(self, nin, nout, mesh, axis):
        self._sharded_geometry(int(nout) * self.audio_decim, mesh.shape[axis])
        return {"group": noise.group_tensor(0, mesh.device)}

    def work_sharded(self, state, ins, params, nout, mesh, axis):
        from newsched_tpu_torch.parallel.channelizer import kernel_tile

        nd = mesh.shape[axis]
        n_rows_tot = int(nout) * self.audio_decim
        n_loc, tile, warm = self._sharded_geometry(n_rows_tot, nd)
        G = noise.GROUP_ROWS
        kt = kernel_tile(tile, int(np.lcm(G, self.audio_decim)),
                         max(self.h8, len(self.audio_taps) - 1))
        amp = params["amplitude"]
        consts = self.consts(amp.device)
        aud = fm_chain.fm_chain_gen_warm_step(
            state["group"], amp, consts, self.audio_decim, self.gain, n_loc,
            warm=warm, tile=kt, seed=self.seed, draws=self.noise_draws, nd=nd)
        return ({"group": noise.advance(state["group"], n_rows_tot // G)},
                {"out": aud})
