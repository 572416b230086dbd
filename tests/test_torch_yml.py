"""The port's YAML block machinery (runtime/blockspec.py, blocks/yml_blocks.py
and the 17 descriptors in blocks/yml/, their ``expr:`` in torch) on the
CPU: every descriptor's block equals its hand-written twin exactly and the
JAX package's descriptor block on the same seeded inputs; static
parameters, rate expressions and port shapes go through the rate algebra;
sizing expressions have no eval surface; GRC metadata renders; an
expression written for jax is refused; and the block library imports with
neither PyYAML nor pyzmq present (the card's machine has neither)."""

import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from newsched_tpu.blocks import yml_blocks as jyml

from newsched_tpu_torch.blocks import general, math as math_blocks, \
    streamops, yml_blocks
from newsched_tpu_torch.runtime.blockspec import _eval_static, \
    block_from_yaml, grc_yaml
from newsched_tpu_torch.runtime.graph import Flowgraph

ROOT = Path(__file__).resolve().parents[1]


def _rand(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "cf32":
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)
    return rng.standard_normal(n).astype(np.float32)


# (yml class, hand-written twin, {port: dtype})
TWINS = [
    ("add_y", lambda: math_blocks.add(2), {"in0": "cf32", "in1": "cf32"}),
    ("multiply_y", lambda: math_blocks.multiply(2), {"in0": "cf32", "in1": "cf32"}),
    ("add_const_y", lambda: math_blocks.add_const(0.5 + 1j, "cf32"), {"in": "cf32"}),
    ("multiply_const_y", lambda: math_blocks.multiply_const(1.5 - 0.5j, "cf32"),
     {"in": "cf32"}),
    ("conjugate_y", lambda: math_blocks.conjugate(), {"in": "cf32"}),
    ("complex_to_mag_y", lambda: math_blocks.complex_to_mag(), {"in": "cf32"}),
    ("complex_to_mag_squared_y", lambda: math_blocks.complex_to_mag_squared(),
     {"in": "cf32"}),
    ("complex_to_real_y", lambda: math_blocks.complex_to_real(), {"in": "cf32"}),
    ("complex_to_imag_y", lambda: math_blocks.complex_to_imag(), {"in": "cf32"}),
    ("float_to_complex_y", lambda: math_blocks.float_to_complex(),
     {"re": "rf32", "im": "rf32"}),
    ("abs_y", lambda: math_blocks.abs_blk(), {"in": "rf32"}),
    ("nlog10_y", lambda: None, {"in": "rf32"}),  # no twin: the formula
    ("keep_one_in_n_y", lambda: streamops.keep_one_in_n(4), {"in": "cf32"}),
    ("keep_m_in_n_y", lambda: streamops.keep_m_in_n(3, 8, offset=2), {"in": "cf32"}),
    ("repeat_y", lambda: streamops.repeat(3), {"in": "cf32"}),
    ("stream_to_vector_y", lambda: streamops.stream_to_vector(8), {"in": "cf32"}),
    ("vector_to_stream_y", lambda: streamops.vector_to_stream(8), {"in": "cf32"}),
]

YML_KWARGS = {
    "add_const_y": {"k": 0.5 + 1j},
    "multiply_const_y": {"k": 1.5 - 0.5j},
    "keep_one_in_n_y": {"n": 4},
    "keep_m_in_n_y": {"m": 3, "n": 8, "offset": 2},
    "repeat_y": {"n": 3},
    "stream_to_vector_y": {"vlen": 8},
    "vector_to_stream_y": {"vlen": 8},
}


def _run_work(blk, ins_np, n):
    """One call of the port block's work on CPU tensors."""
    ins = {k: torch.from_numpy(v) for k, v in ins_np.items()}
    st = blk.init_state(n, 0, "cpu")
    out = blk.work(st, ins, blk.param_leaves("cpu"), n)[1]
    return {k: v.numpy() for k, v in out.items()}


def _run_jax_work(blk, ins_np, n):
    ins = {k: jnp.asarray(v) for k, v in ins_np.items()}
    params = {pid: jnp.asarray(blk.get_param(pid)) for pid in blk._param_specs}
    out = blk.work(blk.init_state(n, 0), ins, params, n)[1]
    return {k: np.asarray(v) for k, v in out.items()}


def _inputs(blk, port_dtypes, n):
    ins = {}
    for i, (port, dt) in enumerate(port_dtypes.items()):
        v = _rand(n, dt, seed=7 + i)
        if port == "in" and blk.inputs[0].item_shape:
            v = v.reshape(-1, *blk.inputs[0].item_shape)
        ins[port] = v
    return ins


@pytest.mark.parametrize("yml_name,twin,port_dtypes",
                         [t for t in TWINS if t[0] != "nlog10_y"],
                         ids=[t[0] for t in TWINS if t[0] != "nlog10_y"])
def test_yml_block_matches_handwritten_twin(yml_name, twin, port_dtypes):
    """Exactly the hand-written twin's output; within 1e-6 of the JAX
    package's descriptor block (its jnp expression) on the same inputs."""
    n = 64
    y = getattr(yml_blocks, yml_name)(**YML_KWARGS.get(yml_name, {}))
    ins = _inputs(y, port_dtypes, n)
    out_y = _run_work(y, ins, n)
    out_h = _run_work(twin(), ins, n)
    out_j = _run_jax_work(getattr(jyml, yml_name)(**YML_KWARGS.get(yml_name, {})),
                          ins, n)
    assert set(out_y) == set(out_h) == set(out_j)
    for k in out_y:
        assert out_y[k].dtype == out_h[k].dtype == out_j[k].dtype
        np.testing.assert_array_equal(out_y[k], out_h[k], err_msg=yml_name)
        np.testing.assert_allclose(out_y[k], out_j[k], rtol=1e-6, atol=1e-6,
                                   err_msg=yml_name)


def test_nlog10_matches_formula_and_reference():
    x = np.abs(_rand(64, "rf32")) + 0.1
    y = yml_blocks.nlog10_y(n=10.0, k=3.0)
    out = _run_work(y, {"in": x}, 64)["out"]
    np.testing.assert_allclose(out, 10.0 * np.log10(x) + 3.0, rtol=1e-5)
    ref = _run_jax_work(jyml.nlog10_y(n=10.0, k=3.0), {"in": x}, 64)["out"]
    np.testing.assert_allclose(out, ref, rtol=1e-5)  # two float32 log10s
    zero = _run_work(y, {"in": np.zeros(4, np.float32)}, 4)["out"]
    np.testing.assert_allclose(zero, -300.0 + 3.0)  # floored at 1e-30


def test_every_shipped_descriptor_is_covered():
    """Every class the loader builds is in the twin table, and the port
    ships the reference's 17 descriptors, no more and no fewer."""
    covered = {t[0] for t in TWINS}
    assert set(yml_blocks.__all__) == covered == set(jyml.__all__)
    assert len(covered) == 17


def _chain(x, blocks, batch):
    src = general.vector_source(x)
    snk = general.vector_sink()
    fg = Flowgraph(batch_size=batch)
    for a, b in zip([src] + blocks, blocks + [snk]):
        fg.connect(a, 0, b, 0)
    fg.run(device="cpu")
    return snk.data()


def test_static_rate_block_through_flowgraph():
    """keep_one_in_n_y (rate 1/n) and repeat_y (rate n) in one graph equal
    the hand-written chain end to end."""
    x = _rand(1024, "cf32", seed=3)
    got = _chain(x, [yml_blocks.keep_one_in_n_y(n=4), yml_blocks.repeat_y(n=2)],
                 256)
    ref = _chain(x, [streamops.keep_one_in_n(4), streamops.repeat(2)], 256)
    np.testing.assert_array_equal(got, ref)
    assert len(got) == len(x) // 4 * 2


def test_vector_shape_descriptor_through_flowgraph():
    """Port-shape references ([vlen]): stream -> vector -> stream is the
    identity at the right rates."""
    x = _rand(512, "cf32", seed=9)
    got = _chain(x, [yml_blocks.stream_to_vector_y(vlen=8),
                     yml_blocks.vector_to_stream_y(vlen=8)], 128)
    np.testing.assert_array_equal(got, x)


def test_yml_keep_m_in_n_reducible_rate_through_flowgraph():
    """in_multiple survives rate reduction: keep_m_in_n_y at m/n = 2/4
    still gets batches whose input counts divide by 4 (1026 requested)."""
    x = _rand(1026 * 2, "cf32", seed=4)
    got = _chain(x, [yml_blocks.keep_m_in_n_y(m=2, n=4, offset=0)], 1026)
    ref = _chain(x, [streamops.keep_m_in_n(2, 4)], 1026)
    np.testing.assert_array_equal(got, ref)


def test_yml_static_validation_rejects_bad_params():
    with pytest.raises(ValueError, match="constraint"):
        yml_blocks.keep_m_in_n_y(m=3, n=8, offset=7)  # offset + m > n
    with pytest.raises(ValueError, match="constraint"):
        yml_blocks.keep_m_in_n_y(m=0, n=8)
    yml_blocks.keep_m_in_n_y(m=3, n=8, offset=5)  # the boundary is allowed


def test_yml_sizing_expressions_have_no_eval_surface():
    assert _eval_static("m/n", {"m": 3, "n": 8}, frac=True) == Fraction(3, 8)
    assert _eval_static("n", {"n": 5}) == 5
    assert _eval_static("0 < m and m <= n", {"m": 2, "n": 4}) is True
    for evil in ("__import__('os')", "m.__class__", "(1,2)[0]",
                 "[x for x in (1,)]", "open('/etc/passwd')", "2**2**64"):
        with pytest.raises(ValueError):
            _eval_static(evil, {"m": 1, "n": 2})


SCALE_OFFSET = """
module: math
block: scale_offset
label: Scale & Offset
parameters:
  - id: k
    dtype: cf32
    default: 2.0
  - id: c
    dtype: cf32
    default: 0.5
ports:
  - {domain: stream, id: in, direction: input, type: cf32}
  - {domain: stream, id: out, direction: output, type: cf32}
expr: "in_ * k + c"
"""


def test_yaml_block_expr():
    data = _rand(512, "cf32")
    got = _chain(data, [block_from_yaml(SCALE_OFFSET)(k=3.0 + 0j)], 128)
    np.testing.assert_allclose(got, data * (3.0 + 0j) + 0.5, rtol=1e-6)


def test_yml_block_library():
    """The shipped descriptors build working blocks, chained in a graph;
    GRC metadata renders for a descriptor-built class, importing the port."""
    data = (np.arange(64) - 32).astype(np.complex64) * (0.5 + 0.25j)
    src = general.vector_source(data)
    chain = [yml_blocks.multiply_const_y(k=2.0 + 0j), yml_blocks.conjugate_y(),
             yml_blocks.complex_to_mag_y()]
    snk = general.vector_sink(dtype="rf32")
    fg = Flowgraph(batch_size=32)
    for a, b in zip([src] + chain, chain + [snk]):
        fg.connect(a, 0, b, 0)
    fg.run(device="cpu")
    np.testing.assert_allclose(snk.data(), np.abs(data * 2.0), rtol=1e-6)
    doc = yaml.safe_load(grc_yaml(yml_blocks.multiply_const_y))
    assert doc["id"] == "math_multiply_const_y"
    assert doc["parameters"][0]["id"] == "k"
    assert doc["templates"]["imports"] == \
        "from newsched_tpu_torch.blocks import math"


def test_grc_export_all_shipped_descriptors():
    for name in yml_blocks.__all__:
        cls = getattr(yml_blocks, name)
        doc = yaml.safe_load(grc_yaml(cls))
        spec = cls.yaml_spec
        assert doc["id"] == f"{spec['module']}_{spec['block']}", name
        n_in = sum(1 for p in spec["ports"] if p["direction"] == "input")
        n_out = sum(1 for p in spec["ports"] if p["direction"] == "output")
        assert len(doc["inputs"]) == n_in and len(doc["outputs"]) == n_out, name
        assert doc["file_format"] == 1, name
    # an instance is introspected: its ports and parameters
    doc = yaml.safe_load(grc_yaml(math_blocks.multiply_const(2.0, "cf32")))
    assert doc["inputs"] == [{"domain": "stream", "id": "in", "dtype": "complex"}]


def test_jnp_expression_is_refused_naming_torch():
    desc = SCALE_OFFSET.replace('"in_ * k + c"', '"jnp.abs(in_) * k + c"')
    with pytest.raises(ValueError, match=r"names jnp.*'torch\.abs\(in_\) \* k \+ c'"):
        block_from_yaml(desc)
    with pytest.raises(ValueError, match="names jax"):
        block_from_yaml(SCALE_OFFSET.replace('"in_ * k + c"',
                                             '"jax.lax.complex(in_, in_)"'))
    # every reference descriptor is refused; every port one builds
    ref_dir = ROOT / "newsched_tpu" / "blocks" / "yml"
    for path in sorted(ref_dir.glob("*.yml")):
        if "jnp" in path.read_text() or "jax" in path.read_text():
            with pytest.raises(ValueError, match="torch"):
                block_from_yaml(str(path))


def test_blocks_import_without_yaml_or_zmq():
    """With yaml and zmq blocked, the block library (and the file, socket,
    ZMQ and audio modules) imports; block_from_yaml then raises an error
    that names PyYAML, and a ZMQ block starts and stops on the port's own
    ZMTP transport (io/zmtp.py), which needs no pyzmq."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['zmq'] = None\n"
        "import newsched_tpu_torch.blocks\n"
        "from newsched_tpu_torch.blocks import zmq, audio, gui, soapy\n"
        "from newsched_tpu_torch.runtime import blockspec\n"
        "try:\n"
        "    blockspec.block_from_yaml('block: x\\nexpr: in_\\n')\n"
        "except ImportError as e:\n"
        "    assert 'PyYAML' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('block_from_yaml ran without yaml')\n"
        "snk = zmq.push_sink('tcp://127.0.0.1:0')\n"
        "snk.start()\n"
        "snk.request_abort()\n"
        "snk.stop()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'newsched_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
