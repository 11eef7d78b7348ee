"""Headless tests for the Tk frontend's props assembly (ref entry GUI,
entry/src/main.rs:75-96 — including the inverted sensitivity slider)."""

import pytest

from dips.gui import SENSITIVITY_MAX, props_from_controls
from dips.properties import (ChromaFilter, DiPsFilter, DiPsMethod,
                             OutputMode)


def test_props_from_controls_defaults():
    p = props_from_controls(True, "sigmoid", "all", "overall", 3, 5.0)
    assert p.output == OutputMode.COLORIZE
    assert p.filter == DiPsFilter.SIGMOID
    assert p.chroma == ChromaFilter.ALL
    assert p.method == DiPsMethod.OVERALL
    assert p.window_size == 3
    assert p.sensitivity == SENSITIVITY_MAX - 5.0  # inverted slider


def test_props_from_controls_variants():
    p = props_from_controls(False, "inv_sig", "g", "per_frame", 6, 2.0)
    assert p.output == OutputMode.GRAYSCALE
    assert p.filter == DiPsFilter.INVERSE_SIGMOID
    assert p.chroma == ChromaFilter.GREEN
    assert p.method == DiPsMethod.PER_FRAME
    assert p.window_size == 5       # even values clamp down, like the ref
    assert p.sensitivity == 8.0


def test_props_from_controls_rejects_unknown():
    with pytest.raises(KeyError):
        props_from_controls(True, "nope", "all", "overall", 3, 5.0)
