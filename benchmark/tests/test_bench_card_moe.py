"""On the card, at the size of each cell of kind ``train_moe``: the
program's readings pass the cell's limits, and the control's (the
reference in float8 products under the program's routing) and each fault's
do not. Marked ``cuda``: it skips without a card.

    python -m pytest benchmark/tests/test_bench_card_moe.py -q -m cuda -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate_moe, common
from benchmark.drivers.train import judge
from benchmark.tests.tiny import BENCH

pytestmark = pytest.mark.cuda
SEED = 5_000_000_011
CELLS = [w["name"] for w in BENCH["workloads"]
         if common.traffic_file(w["traffic"])["kind"] == "train_moe"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(cell, dev):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    doc, traffic = common.config_file(w["config"]), common.traffic_file(w["traffic"])
    out = calibrate_moe.train_seed(doc, traffic, SEED, dev, control=True)
    assert judge(out["program"], traffic["limits"])[0] is True, out["program"]
    for wrong in ("control", "fault_half_batch", "fault_clip_removed", "fault_clip_halved",
                  "fault_capacity_halved"):
        assert judge(out[wrong], traffic["limits"])[0] is False, (wrong, out[wrong])
