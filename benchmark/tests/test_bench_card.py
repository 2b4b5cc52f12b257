"""The controls and faults at each cell's own size, on the card: three
seeds each, read as `benchmark/calibrate.py` reads them and judged by the
cell's limits. Skipped without a CUDA device.

    python -m pytest benchmark/tests/test_bench_card.py -m card
"""

import pytest

from benchmark import calibrate, run
from benchmark.common import compare
from conftest import REPO

SEEDS = [2147484001, 2147484002, 2147484003]
CELLS = ["meta_voc15.train_b64", "yolov2_voc.train_b64", "meta_voc15.train_b384"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_controls_and_faults_fail_their_limits(card, cell):
    _, entry, config, traffic = run.load_cell(REPO, cell)
    ctx = run.Context(REPO, entry, config, traffic, 0, 0.0, False, "cuda", 0.0)
    out = calibrate.train_readings(ctx, [], SEEDS, ["int8", "fp8"])
    limits = compare.load_limits(REPO, cell)
    wrong = [line for line in out if line["kind"] != "program"]
    assert sorted({line["kind"] for line in wrong}) == ["control_fp8", "control_int8",
                                                        "fault_half_batch"]
    assert len(wrong) == 3 * len(SEEDS)
    for line in wrong:
        assert not compare.judge(line, limits)[0], line
    # a step that returns its state unchanged moves no leaf: the change of
    # every leaf the reference moves reads 1 against the reference's
    assert any(name.startswith("delta") and entry["limit"] < 1.0
               for name, entry in limits.items())
