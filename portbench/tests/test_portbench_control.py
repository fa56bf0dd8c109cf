"""The control, the plain reference one precision below the configuration's
(fp8 encoders, fp8 rows for bf16 storage, int4 rows for int8) put in the
program's place, comes out not correct, at a size a CPU test holds; the
program's own run of the same sample stays correct. On the card the same
readings at the cells' sizes come from ``portbench/calibrate.py``."""

import pytest

from portbench.bench import harness

from .conftest import CELLS
from .test_portbench_cells import run_line


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails(tiny_tree, name):
    cell, out, line = run_line(tiny_tree, name, 5, False, control=True)
    assert line["correct"], line["checks"]
    ctl = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in out["control"].items()}
    assert not harness.correct(ctl), ctl
