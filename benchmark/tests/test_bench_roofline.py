"""The benchmark's copy of the roofline arithmetic equals chip_smoke.py's,
and its count of the model's products equals the program's
FlopCounterMode count (evaluation/complexity.py)."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from benchmark import common, roofline
from benchmark.drivers.train import program_config
from benchmark.reference import model as ref_model
from benchmark.tests.tiny import tiny

K1_SHAPES = [(64, 580, 6, 64), (128, 148, 12, 64), (1, 1028, 6, 64)]
K2_SHAPES = [(589824, 96), (147456, 192), (1000, 40)]
DTYPES = [torch.bfloat16, torch.float32]


def test_the_peaks_are_chip_smokes():
    assert roofline.PEAK_FLOPS == chip_smoke.PEAK_FLOPS
    assert roofline.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("kind", [False, True, "fwd", "bwd", "dq", "dkv"])
def test_k1_bound_is_chip_smokes(shape, dtype, kind):
    assert roofline.k1_bound(shape, dtype, kind) == chip_smoke.k1_bound(shape, dtype, kind)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K2_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
def test_k2_bound_is_chip_smokes(shape, dtype, backward):
    assert roofline.k2_bound(shape, dtype, backward) == chip_smoke.k2_bound(shape, dtype, backward)


def test_k2_forward_without_its_residual_reads_one_activation_less():
    M, C = 589824, 40  # bound by its bytes either way
    with_res = roofline.k2_bound((M, C), torch.bfloat16, False)
    without = roofline.k2_bound((M, C), torch.bfloat16, False, residual=False)
    assert with_res["bound_by"] == without["bound_by"] == "bytes"
    assert with_res["bound_ms"] - without["bound_ms"] == pytest.approx(1e3 * M * C * 2 / 3.35e12)


@pytest.mark.parametrize("shape", [(64, 96, 96, 96), (64, 48, 48, 192)])
def test_k3_bound_is_chip_smokes(shape):
    assert roofline.k3_bound(shape, torch.bfloat16) == chip_smoke.k3_bound(shape, torch.bfloat16)


@pytest.mark.parametrize("full_size", [False, True])
def test_forward_products_are_the_programs_flop_count(full_size):
    from linnaeus_tpu_torch.evaluation.complexity import estimate_model_complexity
    from linnaeus_tpu_torch.models.build import build_model

    doc = common.config_file("mFormerV1_sm")
    if not full_size:
        tiny(doc, {"kind": "train"})
    # the plain route: the counter sees the same products as K1's and K2's
    doc["config"]["MODEL"].update(USE_FLASH_ATTN=False, FUSED_CONVNEXT_MLP="off")
    spec = ref_model.spec_from_config(doc["config"], doc["num_classes"])
    model = build_model(program_config(doc), doc["num_classes"], device="cpu")
    counted = estimate_model_complexity(model, spec["img"], sum(d for _, d in spec["meta"]))
    assert roofline.forward_flops(spec) == pytest.approx(counted["flops_per_sample"], rel=1e-9)
