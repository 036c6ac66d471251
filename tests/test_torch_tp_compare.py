"""tools/tp_compare.py at two ranks: dp (2x1), dp x tp (1x2) and dp x sp
(1x2 ring) as gloo processes, the step-1 losses within the tool's 1e-3
(the tool asserts it) and, all three being the one global-batch step, far
closer than that."""

from __future__ import annotations

from linnaeus_tpu_torch.tools.tp_compare import main


def test_dp_tp_and_sp_agree_at_two_ranks(tmp_path, capsys):
    record = main(["--data", "1", "--model", "2", "--steps", "1", "--work", str(tmp_path),
                   "--timeout", "120"])
    assert record["world"] == 2
    assert [record[m]["label"] for m in ("dp", "tp", "sp")] == [
        "dp (2x1)", "dp x tp (1x2)", "dp x sp (1x2) ring"]
    for mode in ("tp", "sp"):
        assert abs(record[mode]["loss_step1"] - record["dp"]["loss_step1"]) < 1e-4
        assert record[mode]["ms_per_step"] > 0
    assert "not scaling" in record["note"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")
