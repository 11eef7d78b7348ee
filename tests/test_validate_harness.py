"""The on-device acceptance harness (`dips.validate`), which chip_smoke.py
runs on the card: pin its case loop, JSON artifact shape, failure
accounting and the tolerance contract of `compare` on the CPU, so a
harness regression can't silently pass on the card."""

import json

import numpy as np
import pytest

from dips import validate
from dips.properties import DiPsFilter, DiPsProperties, OutputMode


def test_quick_xla_matrix_and_json_artifact(tmp_path):
    path = tmp_path / "v.json"
    rc = validate.main(["--quick", "--height", "40", "--width", "150",
                        "--frames", "8", "--json", str(path)])
    assert rc == 0
    doc = json.loads(path.read_text())
    assert doc["ok"] is True
    assert doc["failed"] == 0
    assert doc["geometry"] == [40, 150]
    assert doc["passed"] == len(doc["cases"]) == len(validate.QUICK)
    names = [c["case"] for c in doc["cases"]]
    assert names == list(validate.QUICK)
    for c in doc["cases"]:
        assert c["ok"] is True and "seconds" in c
        assert c["max_u8_diff"] <= 1 and c["tie_flip_frac"] <= 0.01


def test_record_captures_failure():
    results = []

    def boom():
        raise ValueError("bad lane")

    assert validate._case(results, "boom", False, boom) == 1
    (r,) = results
    assert r["ok"] is False
    assert "bad lane" in r["error"]


def test_soak_holds_oracle_and_checkpoint_replay():
    results = []
    assert validate.soak(48, verbose=False, results=results, height=16,
                         width=40, batch=8) == 0
    assert results[0]["ok"] and results[0]["max_u8_diff"] == 0


def test_full_matrix_small_geometry():
    """Every case, plus the hwc and downscale gates, at a small size."""
    results = []
    assert validate.run(verbose=False, results=results, height=24,
                        width=40, n_frames=7, batch=3) == 0
    assert len(results) == len(validate.CASES) + 2


def _expected(props, n=3, h=16, w=16, seed=0):
    r = np.random.default_rng(seed)
    c = props.out_channels
    out = r.integers(1, 254, (n, h, w, c)).astype(np.uint8)
    stats = np.abs(r.normal(size=(n, 4))).astype(np.float32)
    stats[:, 3] = r.integers(0, h * w, n)
    heat = r.random((h, w)).astype(np.float32)
    return out, stats, heat


RAW = DiPsProperties(output=OutputMode.ABSDIFF)
F32 = DiPsProperties()
UNF = DiPsProperties(filter=DiPsFilter.UNFILTERED)


def _perturb(exp, kind):
    out, stats, heat = (a.copy() for a in exp)
    if kind == "lsb":
        out[0, 0, 0, 0] += 1
    elif kind == "two_lsb":
        out[0, 0, 0, 0] += 2
    elif kind == "many_flips":
        out[:, :, :, :] += 1
    elif kind == "stats":
        stats[0, 1] += 1e-2
    elif kind == "count":
        stats[0, 3] += 1
    elif kind == "heat":
        heat[0, 0] += 1e-2
    elif kind == "shape":
        out = out[:-1]
    return out, stats, heat


@pytest.mark.parametrize("props,exact,kind,ok", [
    (RAW, True, "none", True),
    (RAW, True, "lsb", False),          # raw maps are bit-exact
    (RAW, True, "count", False),        # raw changed_count is exact
    (F32, False, "lsb", True),          # 1 LSB: a flipped x.5 tie
    (F32, False, "two_lsb", False),
    (F32, False, "many_flips", True),   # sigmoid path: no flip budget
    (UNF, True, "many_flips", False),   # pure min/max: <= 1% flips
    (F32, False, "count", True),        # knife-edge pixels: 1% of frame
    (F32, False, "stats", False),
    (F32, False, "heat", False),
    (F32, False, "shape", False),
])
def test_compare_tolerances(props, exact, kind, ok):
    exp = _expected(props)
    got = _perturb(exp, kind)
    if ok:
        m = validate.compare(props, got, exp, exact)
        assert m["max_u8_diff"] == (0 if kind in ("none", "count") else 1)
    else:
        with pytest.raises(AssertionError):
            validate.compare(props, got, exp, exact)
