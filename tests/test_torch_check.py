"""``newsched_tpu_torch.check`` on the CPU, on stub tiers (a few seconds):
tier selection, the results JSON, the card's tiers recorded as skipped
with ``"ok": null`` and never as passed, the exit code, and the card
tiers' gates on their last lines."""

import json

import pytest

from newsched_tpu_torch import check


def _stub_tiers(monkeypatch, failing=()):
    """Two CPU tiers, two examples and one card tier, each recording its
    call; the ones in ``failing`` fail."""
    calls = []

    def tier(name):
        def fn():
            calls.append(name)
            return {"label": name, "ok": name not in failing, "seconds": 0.0,
                    "tail": f"{name} output", "_stdout": "kept off",
                    "_out": f"all of {name}'s output"}
        return fn

    names = ("cpu_a", "example:one", "example:two", "cpu_b", "card")
    monkeypatch.setattr(check, "TIERS", {
        n: check.Tier(n == "card", tier(n)) for n in names})
    return calls


def _run(tmp_path, *argv):
    out = tmp_path / "sub" / "check.json"
    rc = check.main(["--out", str(out), *argv])
    return rc, json.loads(out.read_text())


def test_skip_gpu_records_the_card_tiers_as_null(tmp_path, monkeypatch):
    calls = _stub_tiers(monkeypatch)
    rc, res = _run(tmp_path, "--skip-gpu")
    assert rc == 0 and res["ok"] is True
    assert calls == ["cpu_a", "example:one", "example:two", "cpu_b"]
    assert res["tiers"]["card"] == {"ok": None, "skipped": True,
                                    "reason": "--skip-gpu"}
    assert list(res["tiers"]) == list(check.TIERS)
    assert all("_stdout" not in t and "_out" not in t and "log" not in t
               for t in res["tiers"].values())
    assert res["tiers"]["cpu_a"]["tail"] == "cpu_a output"


def test_log_dir_keeps_each_tier_whole(tmp_path, monkeypatch):
    _stub_tiers(monkeypatch)
    rc, res = _run(tmp_path, "--skip-gpu", "--tiers", "examples",
                   "--log-dir", str(tmp_path / "logs"))
    assert rc == 0
    log = tmp_path / "logs" / "example_one.log"
    assert res["tiers"]["example:one"]["log"] == str(log)
    assert log.read_text() == "all of example:one's output"


def test_no_visible_card_is_skipped_not_passed(tmp_path, monkeypatch):
    calls = _stub_tiers(monkeypatch)
    monkeypatch.setattr(check, "gpu_visible", lambda: False)
    rc, res = _run(tmp_path, "--tiers", "card")
    assert rc == 0 and calls == []
    assert res["tiers"] == {"card": {"ok": None, "skipped": True,
                                     "reason": "no CUDA device visible"}}


def test_tier_selection(tmp_path, monkeypatch):
    calls = _stub_tiers(monkeypatch)
    monkeypatch.setattr(check, "gpu_visible", lambda: True)
    rc, res = _run(tmp_path, "--tiers", "card, examples")
    assert rc == 0
    assert calls == ["example:one", "example:two", "card"]
    assert list(res["tiers"]) == calls
    assert check.selected(None) == list(check.TIERS)
    with pytest.raises(SystemExit, match="unknown tiers"):
        check.selected("cpu_a,nope")


def test_a_failed_tier_fails_the_check(tmp_path, monkeypatch, capsys):
    calls = _stub_tiers(monkeypatch, failing=("cpu_b",))
    rc, res = _run(tmp_path, "--skip-gpu")
    assert rc == 1 and res["ok"] is False
    assert calls[-1] == "cpu_b" and res["tiers"]["cpu_b"]["ok"] is False
    assert "CHECK FAILED: cpu_b" in capsys.readouterr().out


@pytest.mark.parametrize("tier,last,ok", [
    ("chip_smoke", {"ok": True, "device": {"platform": "gpu", "kind": "H100",
                                           "count": 1}}, True),
    ("chip_smoke", {"ok": True, "device": {"platform": "cpu"}}, False),
    ("chip_smoke", None, False),
    ("bench", {"value": 42450.2, "device": "NVIDIA H100"}, True),
    ("bench", {"value": 42450.2, "device": "NVIDIA H100",
               "error": "SNR gate failed"}, False),
    ("bench", {"value": 10.0, "device": "NVIDIA H100"}, False),
    ("bench", {"value": 42450.2, "device": "cpu"}, False),
])
def test_card_tiers_gate_on_their_last_line(monkeypatch, tier, last, ok):
    """A card tier passes only if its command exits 0 and its last line
    says so: chip_smoke.py's ``"ok": true`` on a "gpu" platform, the
    bench's headline without an error, on the card, above the floor."""
    out = "log line\n" + ("" if last is None else json.dumps(last))
    monkeypatch.setattr(check, "run", lambda *a, **k: {
        "label": tier, "ok": True, "seconds": 0.0, "tail": out,
        "_stdout": out})
    res = getattr(check, tier)()
    assert res["ok"] is ok and res["result"] == last
