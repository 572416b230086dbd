"""The host boundary of the port on the CPU: the native ring
(newsched_tpu_torch/io), the file, socket, ZMQ, audio and GUI blocks, the
runner's host hooks (staging, host_push, StreamAborted, the loop kept for
host I/O), and config #2 fed from a file, each held against the JAX
package on the same numpy inputs made from a seed. Every thread a test
starts is joined with a timeout and asserted ended."""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from newsched_tpu import Flowgraph as JFlowgraph, models as jmodels
from newsched_tpu.blocks import fileio as jfileio, general as jgen, \
    network as jnet, zmq as jzmq
from newsched_tpu.ops import firdes

from newsched_tpu_torch import Flowgraph, models as tmodels, testing
from newsched_tpu_torch.blocks import audio, fileio, general, gui, network, \
    zmq as tzmq
from newsched_tpu_torch.io import VmcircRing, native_available
from newsched_tpu_torch.runtime import runner as trunner
from newsched_tpu_torch.runtime.block import Block, StreamAborted

JOIN_S = 60
GAIN = 0.5


@pytest.fixture
def tmpfile(tmp_path):
    return str(tmp_path / "stream.bin")


def _cf32(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _thread(body):
    """Run ``body`` on a thread; returns (thread, errors list)."""
    err = []

    def run():
        try:
            body()
        except Exception as e:  # raised again by _join
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, err


def _join(t, err):
    t.join(timeout=JOIN_S)
    assert not t.is_alive(), "thread did not finish"
    if err:
        raise err[0]


def test_native_ring_builds_into_build_dir_and_roundtrips():
    from newsched_tpu_torch.io import native_ring

    assert native_available()
    assert native_ring._build().parent == native_ring.BUILD_DIR
    r = VmcircRing(1 << 16)
    assert r.capacity >= 1 << 16
    data = np.arange(1000, dtype=np.float32)
    assert r.write(data) == data.nbytes
    out = np.empty(1000, np.float32)
    assert r.read_into(out) == data.nbytes
    assert np.array_equal(out, data)
    r.close()


def test_native_ring_wrap():
    r = VmcircRing(1 << 12)  # one page
    cap = r.capacity
    chunk = np.arange(cap // 8, dtype=np.float32)
    total, outs = 0, []
    for i in range(12):  # more than 3x the capacity: the wrap, repeatedly
        block = (chunk + i * len(chunk)).astype(np.float32)
        assert r.write(block) == block.nbytes
        out = np.empty(len(block), np.float32)
        assert r.read_into(out) == block.nbytes
        outs.append(out)
        total += block.nbytes
    assert np.array_equal(np.concatenate(outs),
                          np.arange(12 * len(chunk), dtype=np.float32))
    assert total > 3 * cap


def _file_run(pkg, path, batch, **kw):
    fio, gen, FG = (jfileio, jgen, JFlowgraph) if pkg == "jax" else \
        (fileio, general, Flowgraph)
    fg = FG(batch_size=batch)
    src = fio.file_source(path, **kw)
    snk = gen.vector_sink()
    fg.connect(src, 0, snk, 0)
    fg.run() if pkg == "jax" else fg.run(device="cpu")
    return snk.data(), src


@pytest.mark.parametrize("use_native", [True, False], ids=["ring", "memmap"])
def test_file_roundtrip_graph_matches_reference(tmpfile, use_native):
    """10000 items in batches of 2048: the last batch zero-padded and
    trimmed to the file's items, as the reference's; the ring carried every
    byte (use_native=True) or none (the memmap reads)."""
    data = _cf32(10_000, seed=1)
    data.tofile(tmpfile)
    got, src = _file_run("torch", tmpfile, 2048, use_native=use_native)
    ref, _ = _file_run("jax", tmpfile, 2048, use_native=use_native)
    assert np.array_equal(got, data)
    assert np.array_equal(ref, data)
    assert src.ring_reads == (data.nbytes if use_native else 0)


def test_file_source_auto_logs_its_path(tmpfile, caplog):
    data = _cf32(3000, seed=2)
    data.tofile(tmpfile)
    with caplog.at_level("INFO", logger="newsched_tpu_torch"):
        got, src = _file_run("torch", tmpfile, 1024)
    assert np.array_equal(got, data)
    assert src.ring_reads == data.nbytes
    assert "native ring (use_native=None)" in caplog.text


def test_file_sink(tmpfile):
    data = _cf32(4_000, seed=3)
    fg = Flowgraph(batch_size=1024)
    src = general.vector_source(data)
    snk = fileio.file_sink(tmpfile)
    fg.connect(src, 0, snk, 0)
    fg.run(device="cpu")
    assert np.array_equal(np.fromfile(tmpfile, dtype=np.complex64), data)


def test_file_pump_streams_large(tmpfile):
    """A file 64 times the ring's size through it."""
    data = np.arange(1 << 18, dtype=np.float32)  # 1 MB
    data.tofile(tmpfile)
    r = VmcircRing(1 << 14)
    r.start_file_pump(tmpfile, loop=False)
    out = np.empty_like(data)
    assert r.read_exact(out, timeout=30.0)
    assert np.array_equal(out, data)
    assert r.reads == data.nbytes
    r.close()


def test_starved_ring_raises_and_abort_ends_a_read():
    """A pump that brings nothing raises TimeoutError after its timeout; a
    stop from another thread ends a waiting read with StreamAborted."""
    rd, wr = os.pipe()
    try:
        r = VmcircRing(1 << 14)
        r.start_fd_pump(rd, owns_fd=False)
        out = np.empty(16, np.float32)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="starved"):
            r.read_exact(out, timeout=0.3)
        assert time.monotonic() - t0 < 5
        stop = threading.Event()
        timer = threading.Timer(0.2, stop.set)
        timer.start()
        with pytest.raises(StreamAborted):
            r.read_exact(out, timeout=30.0, abort=stop)
        timer.join(timeout=JOIN_S)
        assert not timer.is_alive()
        r.close()
    finally:
        os.close(rd)
        os.close(wr)


def test_native_ring_fd_pump_and_drain(tmpfile):
    """pipe -> ring (pump); ring -> file (drain) with backpressure."""
    data = np.arange(10000, dtype=np.int32)
    r = VmcircRing(1 << 16)
    rd, wr = os.pipe()
    r.start_fd_pump(rd, owns_fd=True)
    os.write(wr, data.tobytes())
    os.close(wr)
    out = np.empty(10000, np.int32)
    assert r.read_exact(out)
    np.testing.assert_array_equal(out, data)
    r.close()
    r2 = VmcircRing(1 << 14)  # much smaller than the payload
    r2.start_file_drain(tmpfile)
    for _ in range(4):
        r2.write_all(data)
    r2.set_eof()
    r2.wait_drained()
    assert r2.drain_bytes == 4 * data.nbytes
    np.testing.assert_array_equal(np.fromfile(tmpfile, np.int32),
                                  np.tile(data, 4))
    r2.close()


@pytest.mark.parametrize("use_native", [True, False], ids=["ring", "python"])
def test_tcp_roundtrip(use_native):
    n, batch = 8192, 1024
    port = _free_port()
    data = _cf32(n, seed=4)
    rx_snk = general.vector_sink()
    rx_src = network.tcp_source(port, mode="server", use_native=use_native)

    def rx_body():
        fg = Flowgraph(batch_size=batch)
        hd = general.head(n)
        fg.connect(rx_src, 0, hd, 0)
        fg.connect(hd, 0, rx_snk, 0)
        fg.run(device="cpu")

    rx = _thread(rx_body)
    fg = Flowgraph(batch_size=batch)
    src = general.vector_source(data)
    snk = network.tcp_sink(port, mode="client", use_native=use_native)
    fg.connect(src, 0, snk, 0)
    fg.run(device="cpu")
    _join(*rx)
    np.testing.assert_array_equal(rx_snk.data(), data)
    assert rx_src.ring_reads == (data.nbytes if use_native else 0)


def test_udp_roundtrip():
    n, batch = 4096, 512
    port = _free_port()
    data = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    rx_snk = general.vector_sink(dtype="rf32")
    rx_src = network.udp_source(port, dtype="rf32", use_native=True)

    def rx_body():
        fg = Flowgraph(batch_size=batch)
        hd = general.head(n, dtype="rf32")
        fg.connect(rx_src, 0, hd, 0)
        fg.connect(hd, 0, rx_snk, 0)
        fg.run(device="cpu")

    rx = _thread(rx_body)
    deadline = time.monotonic() + 10  # UDP has no handshake: wait for bind
    while rx_src._sock is None:
        assert time.monotonic() < deadline, "udp_source never bound"
        time.sleep(0.01)
    fg = Flowgraph(batch_size=batch)
    src = general.vector_source(data, dtype="rf32")
    snk = network.udp_sink(port, dtype="rf32", payload_bytes=1024,
                           use_native=True)
    fg.connect(src, 0, snk, 0)
    fg.run(device="cpu")
    _join(*rx)
    np.testing.assert_array_equal(rx_snk.data(), data)


TAGS = [(0, "start", 1.0), (1500, "mid", 2.5, -1.0), (3000, "rich", {"id": 7}),
        (4000, "end")]


def _tag_tuples(tags):
    return [(t.offset, t.key, tuple(t.value), t.payload) for t in tags]


class _xpub_sink(tzmq.pub_sink):
    """pub_sink on an XPUB socket, which shows its subscriptions: start()
    returns once the subscriber's has arrived, so no batch is sent before
    a subscriber holds it (a PUB drops those) and no test waits on a
    sleep. Sending is pub_sink's own code."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.sock_type = "XPUB"

    def start(self):
        super().start()
        assert self._sock.poll(JOIN_S * 1000), "no subscriber"
        assert self._sock.recv() == b"\x01"  # subscribe to everything


@pytest.mark.parametrize("kind", ["push_pull", "pub_sub"])
def test_zmq_roundtrip_with_tags(kind):
    """Items and tags (numeric and rich) exact through a port sink and a
    port source of each socket pair."""
    n, batch = 4096, 512
    data = _cf32(n, seed=6)
    addr = f"tcp://127.0.0.1:{_free_port()}"
    snk_cls, src_cls = ((tzmq.push_sink, tzmq.pull_source) if kind == "push_pull"
                        else (_xpub_sink, tzmq.sub_source))
    rx_snk = general.vector_sink()
    rx_src = src_cls(addr, bind=False, timeout_s=30.0, tag_capacity=4)

    def rx_body():
        fg = Flowgraph(batch_size=batch)
        hd = general.head(n)
        fg.connect(rx_src, 0, hd, 0)
        fg.connect(hd, 0, rx_snk, 0)
        fg.run(device="cpu")

    rx = _thread(rx_body)
    fg = Flowgraph(batch_size=batch)
    src = general.vector_source(data, tags=TAGS)
    snk = snk_cls(addr, bind=True)
    fg.connect(src, 0, snk, 0)
    fg.run(device="cpu")
    _join(*rx)
    np.testing.assert_array_equal(rx_snk.data(), data)
    assert _tag_tuples(rx_snk.tags()) == [
        (0, "start", (1.0, 0.0), None), (1500, "mid", (2.5, -1.0), None),
        (3000, "rich", (0.0, 0.0), {"id": 7}), (4000, "end", (0.0, 0.0), None)]


def _send_recv(tx_pkg, rx_pkg, transport, data, tags):
    """A sink of ``tx_pkg`` feeds a source of ``rx_pkg`` over ``transport``;
    returns the received items and tags."""
    n, batch = len(data), 512
    port = _free_port()
    mods = {"jax": (JFlowgraph, jgen, jnet, jzmq),
            "torch": (Flowgraph, general, network, tzmq)}
    RFG, rgen, rnet, rzmq = mods[rx_pkg]
    TFG, tgen, tnet, tzmq_ = mods[tx_pkg]
    rx_snk = rgen.vector_sink()
    if transport == "zmq":
        rx_src = rzmq.pull_source(f"tcp://127.0.0.1:{port}", bind=False,
                                  timeout_s=60.0, tag_capacity=len(tags))
    else:
        rx_src = rnet.tcp_source(port, mode="server")

    def rx_body():
        fg = RFG(batch_size=batch)
        hd = rgen.head(n)
        fg.connect(rx_src, 0, hd, 0)
        fg.connect(hd, 0, rx_snk, 0)
        fg.run() if rx_pkg == "jax" else fg.run(device="cpu")

    rx = _thread(rx_body)
    fg = TFG(batch_size=batch)
    src = tgen.vector_source(data, tags=tags if transport == "zmq" else None)
    snk = (tzmq_.push_sink(f"tcp://127.0.0.1:{port}", bind=True)
           if transport == "zmq" else tnet.tcp_sink(port, mode="client"))
    fg.connect(src, 0, snk, 0)
    fg.run() if tx_pkg == "jax" else fg.run(device="cpu")
    _join(*rx)
    return rx_snk.data(), [(t.offset, t.key, tuple(t.value), t.payload)
                           for t in rx_snk.tags()]


@pytest.mark.parametrize("transport", ["zmq", "tcp"])
@pytest.mark.parametrize("tx,rx", [("torch", "jax"), ("jax", "torch")],
                         ids=["port_to_jax", "jax_to_port"])
def test_cross_package_stream(tx, rx, transport):
    """The wire is the reference's byte for byte: a sink of one package
    feeds a source of the other, items exact and (ZMQ) tags exact."""
    data = _cf32(3000, seed=7)
    tags = [(0, "start", 1.0), (1234, "mid", 2.5, -1.0), (2999, "end")]
    got, got_tags = _send_recv(tx, rx, transport, data, tags)
    np.testing.assert_array_equal(got, data)
    if transport == "zmq":
        assert got_tags == [(0, "start", (1.0, 0.0), None),
                            (1234, "mid", (2.5, -1.0), None),
                            (2999, "end", (0.0, 0.0), None)]
    else:
        assert got_tags == []


def test_zmq_wire_format_is_the_references():
    arr = _cf32(7, seed=8)
    tags = [(5, "k", [1.0, 2.0], {"p": 1})]
    for eof, abort in ((False, False), (True, False), (False, True)):
        assert tzmq._encode_batch(arr, tags, eof, abort) == \
            jzmq._encode_batch(arr, tags, eof, abort)
    h, p = tzmq._decode_batch(jzmq._encode_batch(arr, tags))
    assert h["tags"] == [[5, "k", [1.0, 2.0], {"p": 1}]]
    np.testing.assert_array_equal(p, arr)


def test_wav_roundtrip(tmp_path):
    path = str(tmp_path / "test.wav")
    t = np.arange(48000) / 48000
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    fg = Flowgraph(batch_size=8192)
    src = general.vector_source(tone, dtype="rf32")
    snk = audio.wav_sink(path, sample_rate=48000)
    fg.connect(src, 0, snk, 0)
    fg.run(device="cpu")
    fg2 = Flowgraph(batch_size=8192)
    src2 = audio.wav_source(path)
    snk2 = general.vector_sink(dtype="rf32")
    fg2.connect(src2, 0, snk2, 0)
    fg2.run(device="cpu")
    back = snk2.data()
    assert back.shape == tone.shape
    assert np.max(np.abs(back - tone)) < 1e-4


def test_gui_sinks(tmp_path):
    from newsched_tpu_torch.blocks import analog

    png_f = str(tmp_path / "freq.png")
    png_t = str(tmp_path / "time.png")
    fg = Flowgraph(batch_size=2048)
    src = analog.sig_source(1e6, "complex", frequency=100e3)
    hd = general.head(8192)
    fs = gui.freq_sink(sampling_freq=1e6, png_path=png_f)
    ts = gui.time_sink(dtype="cf32", png_path=png_t)
    fg.connect(src, 0, hd, 0)
    fg.connect(hd, 0, fs, 0)
    fg.connect(hd, 0, ts, 0)
    fg.run(device="cpu")
    freqs, psd = fs.psd()
    assert abs(freqs[np.argmax(psd)] - 100e3) < 2e3
    assert os.path.getsize(png_f) > 1000 and os.path.getsize(png_t) > 1000
    assert ts.data().shape == (8192,)


def test_alsa_blocks_gate_cleanly_without_hardware():
    snk = audio.alsa_sink(sample_rate=8000)
    src = audio.alsa_source(sample_rate=8000)
    if audio.alsa_available():
        try:
            snk.start()
            snk.stop()
            src.start()
            src.stop()
        except RuntimeError as e:
            assert "snd_pcm" in str(e)  # libasound present, no PCM device
    else:
        with pytest.raises(RuntimeError, match="libasound|snd_pcm"):
            snk.start()
        with pytest.raises(RuntimeError, match="libasound|snd_pcm"):
            src.start()


def test_soapy_gates_on_its_module():
    from newsched_tpu_torch.blocks import soapy

    src = soapy.source(sample_rate=1e6)
    try:
        import SoapySDR  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="SoapySDR"):
            src.start()


def test_host_io_graph_refuses_graph_mode_and_runs_the_loop(tmpfile):
    """A file_source graph is never captured (the staged batch's address
    would replay stale samples): ``_can_graph`` is False where the same
    graph from memory allows it, and a run builds no chunk."""
    data = _cf32(4096, seed=9)
    data.tofile(tmpfile)

    def runner(src):
        fg = Flowgraph(batch_size=1024)
        snk = general.vector_sink()
        fg.connect(src, 0, snk, 0)
        fg.validate()
        return trunner.Runner(fg, device="cpu", batch_size=1024), snk

    r_mem, _ = runner(general.vector_source(data))
    r_file, snk = runner(fileio.file_source(tmpfile, use_native=True))
    assert r_mem._can_graph() and not r_file._can_graph()
    assert r_file._has_host_io and r_file.cfg.n_batches == 4
    r_file.run_to_completion()
    assert r_file._chunk is None
    assert np.array_equal(snk.data(), data)


def test_unbounded_file_source_repeat_runs_the_loop_under_start_stop(
        tmpfile, monkeypatch):
    """file_source(repeat=True) under start()/stop(): the loop, never the
    chunked replays; the ring's last items are the file's, repeated."""
    data = _cf32(1000, seed=10)
    data.tofile(tmpfile)

    def no_chunks(self, *a, **k):
        raise AssertionError("a host-I/O graph took the chunked replays")

    monkeypatch.setattr(trunner.Runner, "_run_unbounded_chunked", no_chunks)
    fg = Flowgraph(batch_size=256)
    src = fileio.file_source(tmpfile, repeat=True, use_native=True)
    snk = general.vector_sink(capacity=2048)
    fg.connect(src, 0, snk, 0)
    r = fg.start(device="cpu")
    deadline = time.monotonic() + JOIN_S
    while r.stats["batches"] < 20:
        assert time.monotonic() < deadline and r._thread.is_alive()
        time.sleep(0.01)
    fg.stop()
    r._thread.join(timeout=JOIN_S)
    assert not r._thread.is_alive()
    fg.wait()
    got = snk.data()
    n = r.stats["batches"] * 256
    assert len(got) >= 2048 and n >= 20 * 256
    want = np.resize(data, n)[n - len(got):]
    np.testing.assert_array_equal(got, want)
    assert src.ring_reads >= n * 8


class _aborting_source(Block):
    """Emits batches of ones; the ``abort_at``-th host_pull raises
    StreamAborted, as a host-I/O block does on a local stop."""

    host_io = True

    def __init__(self, abort_at, name=None):
        super().__init__(name)
        self.add_output("out", "rf32")
        self.abort_at, self.pulls = abort_at, 0

    def host_pull(self, nout):
        self.pulls += 1
        if self.pulls == self.abort_at:
            raise StreamAborted("stopped")
        return np.full(nout, self.pulls, np.float32)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["host_in"]}


def test_stream_aborted_ends_the_run_cleanly():
    fg = Flowgraph(batch_size=128)
    src = _aborting_source(abort_at=3)
    hd = general.head(10 * 128, dtype="rf32")
    snk = general.vector_sink(dtype="rf32")
    fg.connect(src, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    r = fg.run(device="cpu")
    assert r.stats["batches"] == 2
    np.testing.assert_array_equal(snk.data(),
                                  np.repeat([1.0, 2.0], 128).astype(np.float32))


def test_staging_keeps_dict_batches_and_dtypes():
    stage = trunner._Staging(torch.device("cpu"))
    batch = {"data": _cf32(8, seed=11), "valid": np.array([True, False]),
             "keys": np.array([3, 4], np.int32)}
    out = stage(("b",), batch)
    assert out["data"].dtype == torch.complex64
    assert out["valid"].dtype == torch.bool
    assert out["keys"].dtype == torch.int32
    np.testing.assert_array_equal(out["data"].numpy(), batch["data"])


# -- config #2 fed from a file: fused and staged -----------------------------

def _design(M, L, A, decim):
    return (firdes.prototype_channelizer_taps(M, L),
            firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A))


def _config2(pkg, fused, source, sink, M, L, A, decim, rows, nb):
    _, at = _design(M, L, A, decim)
    kw = {}
    if pkg == "jax" and fused:
        import jax

        kw = dict(interpret=True, precision=jax.lax.Precision.HIGHEST)
    models = jmodels if pkg == "jax" else tmodels
    fg, blks = models.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=decim, fused=fused,
        source=source, batch_size=rows * M, sink=sink,
        n_samples=nb * rows // decim,
        deviation_frac=1.0 / (2 * np.pi * GAIN), audio_taps=at, **kw)
    fg.run() if pkg == "jax" else fg.run(device="cpu")
    return blks


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_config2_from_a_file_matches_reference_and_memory(tmp_path, fused):
    """Config #2 at M = 16 over 3 batches, fed from one cf32 file: the port
    through file_source (the ring) into file_sink, the port from memory
    into vector_sink, the JAX package through its file_source. The file_sink
    bytes equal the memory-fed vector_sink's exactly (the host boundary
    changes no bit); the reference agrees within the slice's tolerances
    (fused: rtol 2e-4, atol 2e-5; staged: 5e-4 off the branch-cut mask) and
    the golden passes its gate."""
    M, L, A, decim, rows, nb = 16, 8, 33, 4, 256, 3
    path, out = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    x = _cf32(nb * rows * M, seed=12) * np.float32(0.5)
    x.tofile(path)
    src = fileio.file_source(path, use_native=True)
    _config2("torch", fused, src,
             fileio.file_sink(out, dtype="rf32", vlen=(M,)),
             M, L, A, decim, rows, nb)
    assert src.ring_reads == x.nbytes
    from_file = np.fromfile(out, np.float32).reshape(-1, M)
    mem = _config2("torch", fused, general.vector_source(x), "vector",
                   M, L, A, decim, rows, nb)["sink"].data()
    assert from_file.shape == mem.shape == (nb * rows // decim, M)
    assert from_file.tobytes() == mem.tobytes()
    ref = _config2("jax", fused, jfileio.file_source(path), "vector",
                   M, L, A, decim, rows, nb)["sink"].data()
    taps, at = _design(M, L, A, decim)
    gold, bad = testing.rows_reference(testing.planes_rows(x, M), taps, at,
                                       nchans=M, audio_decim=decim,
                                       demod_gain=GAIN, return_risk=True)
    if fused:
        np.testing.assert_allclose(from_file, ref, rtol=2e-4, atol=2e-5)
        assert testing.snr_db(gold[~bad], from_file[~bad]) >= 95.0
    else:
        assert np.abs(from_file - ref)[~bad].max() <= 5e-4
        assert testing.snr_db(gold[~bad], from_file[~bad]) >= 60.0


def test_ingest_probe_stages(tmp_path):
    """probes/ingest.py's three stages at a small size on the CPU: a record
    each, the ring carrying every byte, the device stage's checksum the
    file's (the card's rates come only from a chip run)."""
    from newsched_tpu_torch.probes import ingest

    path = ingest.cf32_file(3 * 4096 + 100, seed=13,
                            path=str(tmp_path / "ingest.bin"))
    assert os.path.getsize(path) == 8 * (3 * 4096 + 100)
    np.testing.assert_array_equal(
        ingest.cf32_items(path, 4096, 5),
        np.fromfile(path, np.complex64)[4096:4101])
    recs = ingest.ingest_stages(path, "cpu", runs=1, batch=4096)
    assert [r["probe"] for r in recs] == ["ingest_ring", "ingest_staging",
                                          "ingest_device"]
    assert all(r["ring_bytes"] == os.path.getsize(path) for r in recs)
    assert recs[-1]["checksum"] == pytest.approx(recs[-1]["checksum_host"],
                                                 rel=1e-12, abs=1e-9)
