"""The MoE train step on the card at mFormerV1_sm_moe's training size (384
px, B=128, 8 experts, top-2, capacity 1.25 on every 2nd RoPE block, K1 and
K2 on): two runs of one seed give the same bits, loss and every parameter
after two steps. The dispatch's ``index_put`` sends every dropped choice to
one discarded row, and the combine's ``index_select`` backward adds into
shared rows only the zero gradients of dropped choices, so no float sum
depends on the order of atomics.

Marked ``cuda``: it skips without a CUDA device.

    python -m pytest -q -p no:cacheprovider tests/test_torch_moe_cuda.py -m cuda
"""

from __future__ import annotations

import gc

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's step runs K1 and K2")
    return torch.device("cuda")


def two_steps(dev, seed: int) -> tuple[list, dict]:
    from linnaeus_tpu_torch.tools import train_bench

    run, state = train_bench.build_step(128, 384, True, device=dev, seed=seed, moe=True)
    losses = [run()["loss"].detach().clone() for _ in range(2)]
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    del run, state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, params


def test_two_moe_steps_of_one_seed_give_the_same_bits(dev):
    losses_a, params_a = two_steps(dev, 2024)
    losses_b, params_b = two_steps(dev, 2024)
    assert any(".mlp.wi" in n for n in params_a)
    assert all(torch.equal(a, b) for a, b in zip(losses_a, losses_b)), (losses_a, losses_b)
    differ = [n for n in params_a if not torch.equal(params_a[n], params_b[n])]
    assert differ == []
