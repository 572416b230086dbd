"""The port's QPSK link (models/qpsk.py: qpsk_tx, qpsk_receiver with S2
clock_recovery_mm and S1 costas_loop, their plain versions on the CPU)
held against the JAX package on the same numpy inputs: the transmitter
within 1e-6, the receiver on a stream the reference locks on (phase
0.3 rad, a 0.5-sample fractional delay, 20 dB AWGN; 16384 symbols in
batches of 4096 samples) symbol for symbol equal to the reference's
receiver and, from symbol 2000 at the link's lag, to the transmitted
symbols; two batch sizes and the runner's graph-mode bookkeeping bit-equal
to the loop; and the reference's own symbol errors on chip_smoke.py's
full-width stream, which phase 52 holds the card's run to."""

import numpy as np
import pytest
import torch

from newsched_tpu.models import qpsk as jq

from newsched_tpu_torch import models as tmodels
from newsched_tpu_torch.models import qpsk as tq
from newsched_tpu_torch.runtime import runner as trunner

N_SYMS, SPS = 16384, 4
LAG = 11      # received symbol k + LAG is transmitted symbol k
SETTLE = 2000  # symbols the loops take to lock, left out of the gate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def impair(x: np.ndarray, phase: float = 0.3, delay: float = 0.5,
           snr_db: float = 20.0, seed: int = 0) -> np.ndarray:
    """A fractional delay (a linear phase across the spectrum), a carrier
    phase offset and AWGN at ``snr_db`` of the signal's power."""
    f = np.fft.fftfreq(len(x))
    y = np.fft.ifft(np.fft.fft(x) * np.exp(-2j * np.pi * f * delay))
    y = y * np.exp(1j * phase)
    rng = np.random.default_rng(seed)
    s = np.sqrt(np.mean(np.abs(y) ** 2) / 10 ** (snr_db / 10) / 2)
    y = y + s * (rng.standard_normal(len(y)) + 1j * rng.standard_normal(len(y)))
    return y.astype(np.complex64)


@pytest.fixture(scope="module")
def link():
    syms = np.random.default_rng(1).integers(0, 4, N_SYMS).astype(np.int32)
    fg, b = jq.qpsk_tx(syms, sps=SPS, batch_size=4096)
    fg.run()
    tx = b["sink"].data()
    rx = impair(tx)
    fg, b = jq.qpsk_receiver(rx, sps=SPS, batch_size=4096)
    fg.run()
    return syms, tx, rx, b["sink"].data()


def _receive(rx, batch, mode="run"):
    fg, b = tq.qpsk_receiver(rx, sps=SPS, batch_size=batch)
    if mode == "run":
        fg.run(device="cpu")
    else:
        r = trunner.Runner(fg, device="cpu", batch_size=fg.batch_size)
        nb = r.cfg.n_batches
        r._run_graph(nb, 2) if mode == "graph" else r._run_loop(nb)
    return b["sink"].data()


def test_models_export_the_link():
    assert tmodels.qpsk_tx is tq.qpsk_tx
    assert tmodels.qpsk_receiver is tq.qpsk_receiver
    np.testing.assert_array_equal(tq.qpsk_constellation().points,
                                  jq.qpsk_constellation().points)
    for sps in (2, 4, 8):
        np.testing.assert_array_equal(tq.rrc_taps(sps), jq.rrc_taps(sps))
        np.testing.assert_array_equal(tq.rrc_taps(sps, gain=1.0),
                                      jq.rrc_taps(sps, gain=1.0))


def test_qpsk_tx_matches_reference(link):
    syms, tx, _, _ = link
    fg, b = tq.qpsk_tx(syms, sps=SPS, batch_size=4096)
    fg.run(device="cpu")
    got = b["sink"].data()
    assert got.shape == tx.shape == (N_SYMS * SPS,)
    assert np.abs(got - tx).max() <= 1e-6


def test_qpsk_receiver_matches_reference_and_recovers_symbols(link):
    """The port's receiver on the reference's impaired stream: its symbols
    equal the reference receiver's, and the transmitted ones from symbol
    2000 at the lag."""
    syms, _, rx, ref = link
    got = _receive(rx, 4096)
    assert got.shape == ref.shape == (N_SYMS,)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[SETTLE + LAG:], syms[SETTLE:N_SYMS - LAG])


def test_qpsk_receiver_batch_sizes_and_graph_mode_bit_equal(link):
    """Batches of 16384 samples equal batches of 4096, and the runner's
    graph-mode bookkeeping (chunks of 2 steps, a remainder) equals its loop,
    symbol for symbol."""
    _, _, rx, ref = link
    rx = rx[:5 * 4096]
    small = _receive(rx, 4096, "graph")
    np.testing.assert_array_equal(small, _receive(rx, 4096, "loop"))
    np.testing.assert_array_equal(small, ref[:len(small)])
    np.testing.assert_array_equal(_receive(rx[:4 * 4096], 16384),
                                  small[:4 * 4096 // SPS])


def test_chip_smoke_link_errors_are_the_references():
    """chip_smoke.py phase 52 holds the port's QPSK link on the card to the
    reference's own symbol errors on its stream (8 batches of 2^20
    samples): the reference's transmitter, chip_smoke's channel and the
    reference's receiver give exactly chip_smoke.QPSK_REF_ERRORS."""
    import chip_smoke as cs

    syms = cs.qpsk_symbols()
    fg, b = jq.qpsk_tx(syms, sps=cs.QPSK_SPS,
                       batch_size=cs.QPSK_BATCH // cs.QPSK_SPS)
    fg.run()
    rx = cs.qpsk_channel(b["sink"].data())
    fg, b = jq.qpsk_receiver(rx[:cs.QPSK_BATCHES * cs.QPSK_BATCH],
                             sps=cs.QPSK_SPS, batch_size=cs.QPSK_BATCH)
    fg.run()
    got = b["sink"].data()
    assert got.shape == (cs.QPSK_BATCHES * cs.QPSK_BATCH // cs.QPSK_SPS,)
    assert cs.qpsk_errors(got, syms) == cs.QPSK_REF_ERRORS
