"""Audio blocks (reference: newsched_tpu/blocks/audio.py, GNU Radio's
blocklib/audio ALSA sink and source).

WAV files are the portable form (scipy.io.wavfile): wav_sink writes the
stream at the end of a run, wav_source streams a file as rf32. The live
ALSA blocks drive libasound through ctypes and are gated on it: where
``alsa_available()`` is False they construct but raise a clear error at
start().
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.runtime.block import Block


class wav_sink(Block):
    """Write rf32 audio to a WAV file at finalize (reference audio::sink's
    persistent cousin)."""

    def __init__(self, path: str, sample_rate: int = 48000, name=None):
        super().__init__(name)
        self.path = path
        self.sample_rate = int(sample_rate)
        self.add_input("in", "rf32")

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def finalize(self, collected, total):
        import scipy.io.wavfile as wf

        arr = np.asarray(collected, dtype=np.float32)
        arr = np.clip(arr, -1.0, 1.0)
        wf.write(self.path, self.sample_rate, arr)


class wav_source(Block):
    """Stream a WAV file as rf32 (reference audio::source's file mode)."""

    def __init__(self, path: str, repeat: bool = False, name=None):
        super().__init__(name)
        import scipy.io.wavfile as wf

        self.sample_rate, data = wf.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        data = data.astype(np.float32)
        if data.ndim > 1:
            data = data[:, 0].copy()
        self._data = data
        self.repeat = repeat
        self.add_output("out", "rf32")
        # the samples stream as a vector_source's, from a copy on the
        # run's device
        from newsched_tpu_torch.blocks.general import vector_source

        self._inner = vector_source(data, repeat=repeat, dtype="rf32")

    def finite_items(self, in_bound):
        return None if self.repeat else len(self._data)

    def init_state(self, nin, nout, device):
        return self._inner.init_state(nin, nout, device)

    def work(self, state, ins, params, nout):
        return self._inner.work(state, ins, {}, nout)


# ---- live ALSA backend (GNU Radio's blocklib/audio ALSA sink/source) -----
#
# A ctypes driver against libasound's "simple setup" API (snd_pcm_set_params
# + writei/readi with xrun recovery), the calls GNU Radio's
# audio_alsa_sink/source make. Gated on the library's presence: a host
# with no sound stack has `alsa_available()` False, and wav_sink/wav_source
# are the portable form there.

_SND_PCM_STREAM_PLAYBACK = 0
_SND_PCM_STREAM_CAPTURE = 1
_SND_PCM_FORMAT_FLOAT_LE = 14
_SND_PCM_ACCESS_RW_INTERLEAVED = 3


def _load_asound():
    import ctypes
    import ctypes.util

    path = ctypes.util.find_library("asound")
    if not path:
        return None
    lib = ctypes.CDLL(path)
    lib.snd_pcm_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.snd_pcm_set_params.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_uint]
    lib.snd_pcm_writei.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_ulong]
    lib.snd_pcm_writei.restype = ctypes.c_long
    lib.snd_pcm_readi.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_ulong]
    lib.snd_pcm_readi.restype = ctypes.c_long
    lib.snd_pcm_recover.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    return lib


def alsa_available() -> bool:
    return _load_asound() is not None


class _alsa_pcm:
    """RAII wrapper over one PCM handle (float32 interleaved)."""

    def __init__(self, device: str, rate: int, channels: int, capture: bool,
                 latency_us: int = 200_000):
        import ctypes

        self.lib = _load_asound()
        if self.lib is None:
            raise RuntimeError(
                "libasound not present on this host: live audio needs an "
                "ALSA stack; use wav_sink/wav_source here")
        self.pcm = ctypes.c_void_p()
        stream = (_SND_PCM_STREAM_CAPTURE if capture
                  else _SND_PCM_STREAM_PLAYBACK)
        rc = self.lib.snd_pcm_open(ctypes.byref(self.pcm), device.encode(),
                                   stream, 0)
        if rc < 0:
            raise RuntimeError(f"snd_pcm_open({device!r}) failed: {rc}")
        rc = self.lib.snd_pcm_set_params(
            self.pcm, _SND_PCM_FORMAT_FLOAT_LE, _SND_PCM_ACCESS_RW_INTERLEAVED,
            int(channels), int(rate), 1, int(latency_us))
        if rc < 0:
            self.close()
            raise RuntimeError(f"snd_pcm_set_params failed: {rc}")
        self.channels = int(channels)

    def write(self, frames: np.ndarray) -> None:
        import ctypes

        buf = np.ascontiguousarray(frames, dtype=np.float32)
        n = len(buf) // self.channels if buf.ndim == 1 else len(buf)
        ptr = buf.ctypes.data_as(ctypes.c_void_p)
        done = 0
        itemsize = 4 * self.channels
        while done < n:
            rc = self.lib.snd_pcm_writei(
                self.pcm, ctypes.c_void_p(ptr.value + done * itemsize),
                n - done)
            if rc < 0:
                rc = self.lib.snd_pcm_recover(self.pcm, int(rc), 1)
                if rc < 0:
                    raise RuntimeError(f"snd_pcm_writei failed: {rc}")
                continue
            done += rc

    def read(self, n: int) -> np.ndarray:
        import ctypes

        out = np.empty((n * self.channels,), np.float32)
        ptr = out.ctypes.data_as(ctypes.c_void_p)
        done = 0
        itemsize = 4 * self.channels
        while done < n:
            rc = self.lib.snd_pcm_readi(
                self.pcm, ctypes.c_void_p(ptr.value + done * itemsize),
                n - done)
            if rc < 0:
                rc = self.lib.snd_pcm_recover(self.pcm, int(rc), 1)
                if rc < 0:
                    raise RuntimeError(f"snd_pcm_readi failed: {rc}")
                continue
            done += rc
        return out if self.channels == 1 else out.reshape(n, self.channels)

    def close(self):
        if self.pcm:
            if hasattr(self.lib, "snd_pcm_drain"):
                self.lib.snd_pcm_drain(self.pcm)
            self.lib.snd_pcm_close(self.pcm)
            self.pcm = None


class alsa_sink(Block):
    """Live audio playback (reference audio::alsa_sink): rf32 stream ->
    the host's ALSA PCM device, streamed batch-by-batch via the runner's
    host_push hook (loop mode; playback pacing IS the throttle)."""

    host_io = True
    collect_is_stream = True

    def __init__(self, sample_rate: int = 48000, device: str = "default",
                 name=None):
        super().__init__(name)
        self.sample_rate = int(sample_rate)
        self.device = device
        self.add_input("in", "rf32")
        self._pcm = None

    def start(self):
        self._pcm = _alsa_pcm(self.device, self.sample_rate, 1, capture=False)

    def stop(self):
        if self._pcm is not None:
            self._pcm.close()
            self._pcm = None

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def host_push(self, batch) -> None:
        self._pcm.write(np.clip(np.asarray(batch, np.float32), -1.0, 1.0))

    def finalize(self, collected, total):
        pass  # streamed live


class alsa_source(Block):
    """Live audio capture (reference audio::alsa_source): ALSA PCM ->
    rf32 stream via the runner's host_pull hook."""

    host_io = True

    def __init__(self, sample_rate: int = 48000, device: str = "default",
                 name=None):
        super().__init__(name)
        self.sample_rate = int(sample_rate)
        self.device = device
        self.add_output("out", "rf32")
        self._pcm = None

    def start(self):
        self._pcm = _alsa_pcm(self.device, self.sample_rate, 1, capture=True)

    def stop(self):
        if self._pcm is not None:
            self._pcm.close()
            self._pcm = None

    def host_pull(self, nout: int) -> np.ndarray:
        return self._pcm.read(nout)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["host_in"]}
