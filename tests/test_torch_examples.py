"""The port's examples (newsched_tpu_torch/examples/), each run through its
``main("cpu")``, which asserts what its twin in examples/ asserts, and the
export_grc twin held against scripts/export_grc.py."""

import importlib
import importlib.util
import os
import warnings

import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["channelizer", "fm_receiver", "live_flagship",
            "sharded_channelizer", "distributed_pipeline",
            "retune_live_receiver", "yaml_block"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, capsys):
    mod = importlib.import_module(f"newsched_tpu_torch.examples.{name}")
    mod.main("cpu")
    assert capsys.readouterr().out.strip()


def _reference_export(outdir):
    spec = importlib.util.spec_from_file_location(
        "export_grc_reference", os.path.join(ROOT, "scripts", "export_grc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with warnings.catch_warnings():  # its deprecated cf32 block
        warnings.simplefilter("ignore", DeprecationWarning)
        return mod.export(outdir)


def test_export_grc_matches_the_reference_script(tmp_path):
    """Every block of the port's library renders; each block's yml equals
    the reference script's for its counterpart wherever the two take the
    same parameters (ids and dtypes): all of it but the label (each
    package's docstring) and the import line's package. Two blocks differ
    on purpose: wbfm_live_source's parameters, and wbfm_rcv_fused's
    center_freq, a float64 tensor on the card (no fixed dtype)."""
    from newsched_tpu_torch import export_grc

    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    written, skipped = export_grc.export(str(port_dir))
    ref_written, _ = _reference_export(str(ref_dir))
    assert written >= 100 and written >= ref_written - 1, skipped
    port_files = set(os.listdir(port_dir))
    ref_files = set(os.listdir(ref_dir))
    # the reference's deprecated cf32 fm_channelizer_fused is not ported
    assert ref_files - port_files == {"vector_dsp_fm_channelizer_fused.block.yml"}
    compared = []
    for f in sorted(port_files & ref_files):
        mine = yaml.safe_load((port_dir / f).read_text())
        ref = yaml.safe_load((ref_dir / f).read_text())
        assert mine["templates"]["imports"].startswith(
            "from newsched_tpu_torch.blocks import ")
        mine["templates"]["imports"] = ref["templates"]["imports"]
        mine.pop("label")
        ref.pop("label")
        if [(p["id"], p["dtype"]) for p in mine["parameters"]] != \
                [(p["id"], p["dtype"]) for p in ref["parameters"]]:
            continue
        assert mine == ref, f
        compared.append(f)
    assert len(compared) >= 100, len(compared)


def test_export_grc_command_line(tmp_path, capsys):
    from newsched_tpu_torch import export_grc

    export_grc.main(["--out", str(tmp_path / "grc")])
    out = capsys.readouterr().out
    assert out.startswith("wrote ")
    assert (tmp_path / "grc" / "general_head.block.yml").exists()
