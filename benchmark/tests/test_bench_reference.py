"""The plain reference against the program at a tiny size on the CPU: the
forward and the training step, with the program computing in float32,
agree to float32 rounding."""

from __future__ import annotations

import pytest
import torch

from benchmark import common, run
from benchmark.drivers.train import program_config
from benchmark.reference import model as ref_model
from benchmark.tests.tiny import BENCH, SEED, tiny_float32


def tiny_doc(config_name: str) -> dict:
    doc = common.config_file(config_name)
    tiny_float32(doc, {"kind": "train"})
    return doc


@pytest.mark.parametrize("config_name", [c["name"] for c in BENCH["configs"]])
def test_reference_forward_matches_the_program(config_name):
    from linnaeus_tpu_torch.models.build import build_model

    doc = tiny_doc(config_name)
    spec = ref_model.spec_from_config(doc["config"], doc["num_classes"])
    model = build_model(program_config(doc), doc["num_classes"], device="cpu", seed=3)
    assert model.dtype == torch.float32
    weights = common.make_weights(ref_model.param_shapes(spec), 11, torch.device("cpu"))
    model.load_state_dict(weights, strict=True)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(3, 64, 64, 3, generator=g)
    aux = torch.randn(3, sum(d for _, d in spec["meta"]), generator=g)
    with torch.no_grad():
        got = model(x, aux)
        want = ref_model.forward(weights, x, aux, spec)
    for t in got:
        torch.testing.assert_close(got[t], want[t], rtol=1e-4, atol=1e-5)


def test_the_layout_is_the_programs_state_dict():
    from linnaeus_tpu_torch.models.build import build_model

    doc = tiny_doc("mFormerV1_sm")
    spec = ref_model.spec_from_config(doc["config"], doc["num_classes"])
    model = build_model(program_config(doc), doc["num_classes"], device="cpu", seed=3)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        ref_model.param_shapes(spec)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_program_and_reference_agree_to_float32_rounding(cell):
    result = run.run_cell(BENCH, cell, SEED, 0.5, False, torch.device("cpu"), adjust=tiny_float32)
    numbers = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"] is True
    for name, value in numbers.items():
        assert value <= 1e-4, (name, value)
