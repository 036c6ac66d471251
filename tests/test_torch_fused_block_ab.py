"""tools/fused_block_ab on the CPU at a tiny geometry: the three contenders
(K3's plain version, library convolution + K2's plain version, the plain
chain) compute the same block, forward and train, and the tool's control
flow runs end to end. fp32 agreement 1e-5 (the same math in another order);
bf16 within K2's bar of 5e-2."""

import json

import pytest
import torch

from linnaeus_tpu_torch.ops import fused_dwconv_mlp as fb
from linnaeus_tpu_torch.ops import fused_mlp as fm
from linnaeus_tpu_torch.tools import fused_block_ab as ab

GEOMETRY = (2, 9, 8, 8)
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_three_modes_agree_forward(dtype):
    outs = {}
    for mode in ab.MODES:
        run, params, x = ab.build(mode, False, *GEOMETRY, dtype=dtype, device="cpu")
        assert x.dtype == dtype and params["w1"].shape == (32, 8) and params["k"].shape == (8, 1, 7, 7)
        outs[mode] = run(1).float()
        assert outs[mode].shape == GEOMETRY and torch.isfinite(outs[mode]).all()
    for mode in ("block", "mlp"):
        assert (outs[mode] - outs["plain"]).abs().max().item() <= TOL[dtype], mode
    # a chain of three blocks feeds each output to the next
    run, _, x = ab.build("plain", False, *GEOMETRY, dtype=dtype, device="cpu")
    assert not torch.equal(run(3), run(1))


def test_three_modes_agree_in_training():
    """Two iterations of forward + backward + the 1e-6 update: same summed
    loss and same parameter updates through all three routes. An update is
    1e-6 of a gradient, so it is held to 1e-3 of the largest update of its
    tensor plus one float32 step of the parameter it was added to."""
    results = {}
    for mode in ab.MODES:
        run, params, _ = ab.build(mode, True, *GEOMETRY, dtype=torch.float32, device="cpu")
        before = {n: t.detach().clone() for n, t in params.items()}
        total = run(2)
        moved = {n: t.detach() - before[n] for n, t in params.items()}
        assert all(m.abs().max().item() > 0 for n, m in moved.items() if n in ("k", "w1", "w2")), mode
        results[mode] = (total.item(), moved, before)
    for mode in ("block", "mlp"):
        assert abs(results[mode][0] - results["plain"][0]) <= 1e-5 * abs(results["plain"][0])
        for name, moved in results[mode][1].items():
            ref = results["plain"][1][name]
            step = 1.2e-7 * results["plain"][2][name].abs().max().item()
            assert (moved - ref).abs().max().item() <= step + 1e-3 * ref.abs().max().item(), (mode, name)
    assert fb.LAUNCHES == 0 and fm.LAUNCHES == 0 and fm.BWD_LAUNCHES == 0


@pytest.mark.parametrize("train", [False, True])
def test_main_prints_pairs_and_medians(capsys, train):
    argv = ["--geometry", "1x8x8x8", "--pairs", "2", "--n", "2", "--modes", "block,plain",
            "--dtype", "float32", "--device", "cpu"] + (["--train"] if train else [])
    ab.main(argv)
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [(r["pair"], r["mode"]) for r in lines[:-1]] == [
        (0, "block"), (0, "plain"), (1, "block"), (1, "plain")]
    summary = lines[-1]
    assert summary["train"] is train and summary["card"] == "cpu"
    assert set(summary["ms_median"]) == {"block", "plain"}
    assert all(v > 0 for v in summary["ms_median"].values())


def test_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab.build("plain", False, *GEOMETRY)
    with pytest.raises(SystemExit):
        ab.main(["--modes", "block,xla", "--device", "cpu"])
