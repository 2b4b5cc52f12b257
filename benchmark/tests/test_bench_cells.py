"""Each cell's mix at a tiny size on the CPU, end to end through
`run.main`, and the faults that must turn `correct` false."""

import pytest

from helpers import run_cell

CELLS = ("meta_voc15.train_b64", "yolov2_voc.train_b64", "meta_voc15.train_b384")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_and_loads_no_jax(tiny_root, cell):
    result, status = run_cell(tiny_root, cell)
    assert status == {"rc": 0, "banned": []}
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_img_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_host_metrics(tiny_root, cell):
    result, status = run_cell(tiny_root, cell, trace=1)
    assert status["rc"] == 0 and result["correct"] is True
    # on the CPU the device readers find no device events and stay silent
    assert not any(k.startswith(("device_idle", "conv_", "bn_sums_"))
                   for k in result["metrics"])
    assert "breakdown" in result and "busy_s" in result["device"]


@pytest.mark.parametrize("cell,fault", [
    ("meta_voc15.train_b64", "state_unchanged"),
    ("meta_voc15.train_b64", "half_batch"),
    ("yolov2_voc.train_b64", "state_unchanged"),
    ("yolov2_voc.train_b64", "half_batch"),
    ("meta_voc15.train_b384", "state_unchanged"),
    ("meta_voc15.train_b384", "half_batch"),
])
def test_planted_fault_turns_correct_false(tiny_root, cell, fault):
    result, status = run_cell(tiny_root, cell, fault=fault)
    assert status["rc"] == 0
    assert result["correct"] is False, result["checks"]
