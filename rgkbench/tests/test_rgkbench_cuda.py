"""On the card: one short run of each cell, correct."""

import pytest

from rgkbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.spec()["workloads"]])
def test_cell_runs_correct_on_the_card(cell, cuda_device, tmp_path):
    wl = harness.workload(cell)
    out = harness.run_cell(cell, 2 ** 31 + 3, 1.0, False, cuda_device,
                           wl=wl, scenes=str(tmp_path))
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
