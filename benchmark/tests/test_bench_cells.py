"""Every cell of BENCHMARK.json through the harness on the CPU at a tiny
geometry: the run is driven whole and checked, and reports no metric."""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import BENCH, SEED, tiny

CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_whole_on_the_cpu_and_reports_no_metric(cell):
    result = run.run_cell(BENCH, cell, SEED, 0.5, False, torch.device("cpu"), adjust=tiny)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_a_traced_run_without_a_card_is_refused():
    with pytest.raises(RuntimeError, match="no card"):
        run.run_cell(BENCH, CELLS[0], SEED, 0.2, True, torch.device("cpu"), adjust=tiny)


def test_the_command_without_a_card_exits_non_zero_and_prints_no_result(capsys, monkeypatch):
    monkeypatch.chdir(run.common.ROOT.parent)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "unused")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_every_cell_names_files_that_exist():
    root = run.common.ROOT
    for w in BENCH["workloads"]:
        cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        assert (root.parent / cfg["file"]).is_file()
        assert (root / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert run.common.metric_reader(m["name"]) is not None, m["name"]
