"""chip_smoke.py's logic on the CPU: the refusal without a GPU, the last
line, and a tiny end-to-end rehearsal of both the one-card and the
four-card runs (the real sizes run only on the card)."""

import functools
import json
import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
sys.path.remove(REPO)


class _Dev:
    def __init__(self, platform, kind="NVIDIA H100 80GB HBM3"):
        self.platform, self.device_kind = platform, kind


def test_refuses_without_gpu(capsys):
    """On the CPU the script exits non-zero and prints no result: the last
    line says ok false and names no device."""
    assert chip_smoke.main([]) == 2
    last = capsys.readouterr().out.strip().splitlines()[-1]
    doc = json.loads(last)
    assert doc["ok"] is False and "device" not in doc
    assert "cpu" in doc["error"]


@pytest.mark.parametrize("platform,ok", [("gpu", True), ("cpu", False),
                                         ("rocm", False)])
def test_require_gpu(platform, ok):
    assert (chip_smoke.require_gpu([_Dev(platform)]) == "") is ok
    assert chip_smoke.require_gpu([]) != ""


@pytest.mark.parametrize("count", [1, 4])
def test_verdict_last_line_exact(count):
    """The last line is exactly the JSON object the contract names, with
    the device as JAX reports it and nothing more."""
    line = chip_smoke.verdict(True, [_Dev("gpu")] * count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": %d}}' % count)
    assert json.loads(chip_smoke.verdict(False, error="x")) == {
        "ok": False, "error": "x"}


def test_smoke_cases_exist_in_validate():
    """Every phase names a validate case (the script runs validate's
    configurations and tolerances, not its own)."""
    names = [c[0] for c in chip_smoke._cases()]
    assert names == list(chip_smoke.SMOKE_CASES)


def _rehearse(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "H", 32)
    monkeypatch.setattr(chip_smoke, "W", 48)
    monkeypatch.setattr(chip_smoke, "BATCH", 5)  # 12 checked: a ragged tail
    monkeypatch.setattr(chip_smoke, "H8", 64)
    monkeypatch.setattr(chip_smoke, "W8", 96)
    monkeypatch.setattr(chip_smoke, "BATCH8", 2)
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda devices: "")
    # no Triton compiler here: the kernels run in interpret mode
    from jax.experimental import pallas as pl
    from dips.ops import median_triton
    monkeypatch.setattr(median_triton, "_pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    from dips.utils import compilecache
    monkeypatch.setattr(compilecache, "enable_compile_cache",
                        lambda: str(tmp_path))


def test_one_card_rehearsal(monkeypatch, tmp_path, capsys):
    """Every one-card phase runs end to end at a tiny size and passes its
    oracle comparison; the verdict comes last."""
    _rehearse(monkeypatch, tmp_path)
    assert chip_smoke.main(["--frames", "8"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    passed = [line for line in out if line.startswith("PASS")]
    from dips.ops import median_triton
    assert len(passed) == (len(chip_smoke.SMOKE_CASES) + 4
                           + len(median_triton.WINDOWS))
    assert sum(line.startswith("PASS kernel median") for line in passed) \
        == len(median_triton.WINDOWS)
    assert any(line.startswith("compile seconds") for line in out)
    doc = json.loads(out[-1])
    assert doc["ok"] is True and doc["device"]["platform"] == "cpu"


def test_four_cards_rehearsal(monkeypatch, tmp_path, capsys):
    """The stream-mesh and rows-mesh checks on four virtual devices."""
    assert len(jax.devices()) >= 4, "conftest provides 8 virtual devices"
    _rehearse(monkeypatch, tmp_path)
    assert chip_smoke.main(["--four-cards", "--frames", "8"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert sum(line.startswith("PASS") for line in out) == 2
    assert json.loads(out[-1])["ok"] is True
