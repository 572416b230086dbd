"""Headless visualization sinks (reference: newsched_tpu/blocks/gui.py,
GNU Radio's blocklib/qtgui time_sink and freq_sink). They collect the
stream as a vector_sink does and, given ``png_path``, render it to a PNG
at the end of the run with matplotlib's Agg backend (imported only then).
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.blocks.general import vector_sink


class time_sink(vector_sink):
    """Collect the stream and optionally render amplitude-vs-time to PNG."""

    def __init__(self, dtype="rf32", vlen=(), npoints: int | None = 4096,
                 png_path: str | None = None, name=None):
        super().__init__(dtype=dtype, vlen=vlen, name=name)
        self.npoints = npoints
        self.png_path = png_path

    def finalize(self, collected, total):
        super().finalize(collected, total)
        if self.png_path:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            d = self.data()
            if self.npoints:
                d = d[: self.npoints]
            fig, ax = plt.subplots(figsize=(8, 3))
            if np.iscomplexobj(d):
                ax.plot(np.real(d), label="I", lw=0.7)
                ax.plot(np.imag(d), label="Q", lw=0.7)
                ax.legend()
            else:
                ax.plot(d, lw=0.7)
            ax.set_xlabel("sample")
            fig.tight_layout()
            fig.savefig(self.png_path, dpi=100)
            plt.close(fig)


class freq_sink(vector_sink):
    """Collect the stream and optionally render a Welch-style PSD to PNG."""

    def __init__(self, sampling_freq: float = 1.0, fft_size: int = 1024,
                 dtype="cf32", png_path: str | None = None, name=None):
        super().__init__(dtype=dtype, name=name)
        self.sampling_freq = float(sampling_freq)
        self.fft_size = int(fft_size)
        self.png_path = png_path
        self._psd = None
        self._freqs = None

    def finalize(self, collected, total):
        super().finalize(collected, total)
        d = self.data()
        n = self.fft_size
        nseg = max(len(d) // n, 1)
        segs = d[: nseg * n].reshape(nseg, n)
        win = np.hanning(n)
        spec = np.fft.fftshift(
            np.mean(np.abs(np.fft.fft(segs * win, axis=1)) ** 2, axis=0)
        )
        self._psd = 10 * np.log10(spec + 1e-20)
        self._freqs = np.fft.fftshift(np.fft.fftfreq(n, 1 / self.sampling_freq))
        if self.png_path:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 3))
            ax.plot(self._freqs, self._psd, lw=0.8)
            ax.set_xlabel("Hz")
            ax.set_ylabel("dB")
            fig.tight_layout()
            fig.savefig(self.png_path, dpi=100)
            plt.close(fig)

    def psd(self):
        return self._freqs, self._psd
