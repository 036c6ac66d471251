"""Stochastic depth as a per-sample scale inside the residual add
(ops/drop_path.py, models/blocks/common.py ``drop_path_add``), on the CPU:
the plain versions against the eager formula ``residual + where(mask,
branch / keep, 0)`` and its autograd gradients, the draws against
``DropPath.forward``'s, the paths that take no scale bit for bit, and the
``drop_path/scaled`` counter of a train step.
"""

import numpy as np
import pytest
import torch

from linnaeus_tpu_torch.models.blocks.common import DropPath, drop_path_add
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.ops import drop_path as dp
from linnaeus_tpu_torch.utils import tracing


def _eager(residual, branch, mask, keep):
    """The formula the scale replaces: DropPath.forward, then the add."""
    m = mask.view((-1,) + (1,) * (branch.dim() - 1))
    return residual + torch.where(m, branch / keep, torch.zeros_like(branch))


@pytest.mark.parametrize("shape", [(6, 5, 8), (6, 3, 4, 8), (7, 13)])
def test_scale_add_matches_the_eager_formula_and_its_gradients(shape):
    gen = torch.Generator().manual_seed(len(shape))
    residual, branch, cot = (torch.randn(shape, generator=gen) for _ in range(3))
    u = torch.tensor([0.1, 0.9, 0.3, 0.7, 0.59, 0.61, 0.2][:shape[0]])
    keep = 0.6
    mask = u < keep
    leaves = [t.clone().requires_grad_() for t in (residual, branch)]
    got = dp.scale_add(*leaves, dp.SampleScale(u, keep))
    (got * cot).sum().backward()
    want_leaves = [t.clone().requires_grad_() for t in (residual, branch)]
    want = _eager(*want_leaves, mask, keep)
    (want * cot).sum().backward()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for b in range(shape[0]):
        if not mask[b]:  # a dropped sample is its residual, bit for bit
            assert torch.equal(got[b], residual[b])
            assert torch.equal(leaves[1].grad[b], torch.zeros_like(branch[b]))
    assert torch.equal(leaves[0].grad, cot)  # the residual's gradient is dout
    torch.testing.assert_close(leaves[1].grad, want_leaves[1].grad, rtol=0, atol=1e-6)
    assert dp.LAUNCHES == 0 and dp.BWD_LAUNCHES == 0


def test_scale_add_rounds_once_in_bfloat16():
    gen = torch.Generator().manual_seed(3)
    residual, branch = (torch.randn(4, 9, 16, generator=gen).bfloat16() for _ in range(2))
    u = torch.tensor([0.2, 0.95, 0.4, 0.6])
    scale = dp.SampleScale(u, 0.9)
    got = dp.scale_add(residual, branch, scale)
    s = scale.values().view(-1, 1, 1)
    want = torch.where(s != 0, residual.float() + branch.float() * s, residual.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())
    assert torch.equal(got[1], residual[1])
    assert scale.values().tolist() == [np.float32(1 / 0.9), 0.0, np.float32(1 / 0.9),
                                       np.float32(1 / 0.9)]


def test_drop_path_add_draws_what_drop_path_draws():
    """The helper takes the uniforms DropPath.forward takes: same generator,
    same shape, same count; the generator ends in the same state."""
    x, y = torch.randn(8, 5, 16), torch.randn(8, 5, 16)
    block = DropPath(0.5).train()
    states = []
    outs = []
    for use_helper in (True, False):
        block.generator = torch.Generator().manual_seed(11)
        outs.append(drop_path_add(x, y, block) if use_helper else x + block(y))
        states.append(block.generator.get_state())
    assert torch.equal(states[0], states[1])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("rate,training", [(0.0, True), (0.3, False), (0.0, False)])
def test_drop_path_add_without_a_scale_is_the_plain_sum(rate, training):
    x, y = torch.randn(4, 7, 8), torch.randn(4, 7, 8)
    block = DropPath(rate).train(training)
    block.generator = torch.Generator().manual_seed(0)
    before = block.generator.get_state()
    assert torch.equal(drop_path_add(x, y, block), x + y)
    assert torch.equal(block.generator.get_state(), before)  # nothing drawn


def _sm_shaped(rate):
    """mFormerV1_sm's 13 blocks (6 ConvNeXt, then 5 + 2 RoPE) at tiny widths."""
    spec = {
        "CONVNEXT": {"DEPTHS": [3, 3, 1, 1], "DIMS": [8, 16, 32, 64]},
        "ROPE": {"DEPTHS": [5, 2], "DIMS": [32, 64], "NUM_HEADS": [2, 4]},
        "DROP_PATH_RATE": rate,
    }
    return build_model(spec, 64, {"taxa_L10": 5}, (("TEMPORAL", 2),), device="cpu")


def test_counter_reads_nineteen_scaled_residuals_a_step():
    """The first ConvNeXt block runs at rate 0; the other 5 and the 14 RoPE
    residuals (attention and MLP of 7 blocks) take the scale."""
    model = _sm_shaped(0.05).train()
    x, m = torch.randn(2, 64, 64, 3), torch.randn(2, 2)
    tracing.reset()
    try:
        with tracing.enabled():
            model(x, m)["taxa_L10"].sum().backward()
        counts = tracing.counters()["drop_path/scaled"]
    finally:
        tracing.reset()
    assert counts.shape == (19, 2)  # a scaled residual's draws, one a sample
    assert ((counts >= 0) & (counts < 1)).all()


def test_counter_is_silent_when_tracing_is_off_or_nothing_is_scaled():
    x, m = torch.randn(2, 64, 64, 3), torch.randn(2, 2)
    tracing.reset()
    _sm_shaped(0.05).train()(x, m)
    assert tracing.counters() == {}
    with tracing.enabled():
        _sm_shaped(0.0).train()(x, m)
        _sm_shaped(0.05).eval()(x, m)
    assert tracing.counters() == {}


def test_drop_path_forward_is_the_scale_of_its_draws():
    """DropPath.forward multiplies by the scale that the residuals apply
    inside their add: the same draws, a dropped sample all zeros, a kept
    one within a rounding of the eager division."""
    x = torch.randn(8, 5, 16)
    block = DropPath(0.5).train()
    block.generator = torch.Generator().manual_seed(3)
    got = block(x)
    block.generator = torch.Generator().manual_seed(3)
    scale = block.sample_scale(x)
    assert torch.equal(got, dp.scale_samples_reference(x, scale))
    mask = scale.u < scale.keep
    assert mask.any() and not mask.all()
    assert not got[~mask].any()
    want = _eager(torch.zeros_like(x), x, mask, scale.keep)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _counting_scale_add(monkeypatch):
    from linnaeus_tpu_torch.models.blocks import common

    calls = []

    def counted(*args):
        calls.append(1)
        return dp.scale_add(*args)

    monkeypatch.setattr(common, "scale_add", counted)
    return calls


def test_drop_path_add_without_kernels_is_the_scaled_sum_in_plain_pytorch(monkeypatch):
    """``kernel`` False: the same draws, values and gradients, and no call
    of the kernel's function."""
    calls = _counting_scale_add(monkeypatch)
    block = DropPath(0.5).train()
    residual, branch, cot = (torch.randn(6, 7, 8) for _ in range(3))
    results = []
    for kernel in (True, False):
        block.generator = torch.Generator().manual_seed(5)
        leaves = [t.clone().requires_grad_() for t in (residual, branch)]
        out = drop_path_add(*leaves, block, kernel=kernel)
        (out * cot).sum().backward()
        results.append((out.detach(), leaves[0].grad, leaves[1].grad,
                        block.generator.get_state()))
    assert len(calls) == 1
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernels", [True, False])
def test_blocks_route_their_residuals_by_their_own_kernel_flags(monkeypatch, kernels):
    """A ConvNeXt block told not to fuse and a RoPE block with K1 off keep
    their scaled residuals in plain PyTorch; with their kernels on (the
    ConvNeXt block left to choose, which on the CPU takes its plain tail)
    they call the scale-add function, once a residual."""
    from linnaeus_tpu_torch.models.blocks.convnext import ConvNeXtBlock
    from linnaeus_tpu_torch.models.blocks.rope_mhsa import RoPE2DMHSABlock

    calls = _counting_scale_add(monkeypatch)
    convnext = ConvNeXtBlock(8, drop_path=0.5, fused_mlp=None if kernels else False).train()
    rope = RoPE2DMHSABlock(16, img_grid_size=(4, 3), extra_token_num=2, num_heads=2,
                           drop_path=0.5, use_flash_attn=kernels).train()
    convnext(torch.randn(3, 5, 5, 8))
    rope(torch.randn(3, 14, 16))
    assert len(calls) == (3 if kernels else 0)
