"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these skip without a CUDA device (the kernels have no
interpret mode). On a GPU machine, from the repository root:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the port does
not need.) The bars are stated once, in ops/kernel_bars.py, which
chip_smoke.py's kernel table reads too. Forward tolerances are the TPU
kernel tests' bars: K1 fp32 2e-5, bf16 3e-2; K2 fp32 1e-5, bf16 5e-2, also
at the train step's rows in float32. The backward kernels are held to their
plain versions relative to each gradient's largest magnitude: fp32 2e-5
(another summation order), bf16 2e-2 (a rounding of P, dS, h1 or da1
that falls the other way moves a sum by a bf16 step or two). K1's backward
is its dQ and dK/dV kernels at every length, each checked alone too, and
two calls give the same bits; K3 (the fused ConvNeXt block) is held to
K2's bars. In bfloat16 all three K1 kernels run on the tensor cores and
are held at every K1 shape of the model at 384 and 512 px, at the rollout's
one image and around the tile edges; float32 stays on the CUDA cores at its
2e-5, at the same lengths. These tests hold the kernels at their tile and
length edges and in both dtypes; chip_smoke.py times them in bf16 at the
shapes the main path launches, each held to the same bar. K2's forward and
backward and K3's MLP tail run on the tensor cores in bfloat16 at widths
that are multiples of 32 (up to 256, 192 and 192) and on the CUDA cores
otherwise; the C side's reports of those routes are held against the
Python rules, the tensor-core forward around its 64-row tile and 64-column
atom edges, the forward and the tensor-core backward at the shapes of a
384 px train step at B = 128 (the same bits twice too) and at
hidden widths of one, three and five chunks, ptxas's report on the
backward's source free of serialised `wgmma`, and a ConvNeXt block left to
choose its route at the lg and xl presets' widths. K1 and K2 inside the
non-reentrant checkpoints of per-block rematerialisation, under each
policy, give the gradients of the run without it (to the backward bars,
with one more forward launch per block), the recompute takes the first
forward's route, and GradNorm's per-task norms with the kernels on and off
agree within the bf16 backward bar. Under drop path's per-sample scale, K2
(every route, the train step's shapes at B = 128 included) and the
scale-add kernel are held to their plain versions, a dropped sample's rows
to the residual bit for bit, two calls to the same bits, and a tiny model
in training launches both.
"""

import copy

import numpy as np
import pytest
import torch

from linnaeus_tpu_torch.models.blocks.common import DropPath
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.ops import drop_path as dpk
from linnaeus_tpu_torch.ops import flash_attention as fa
from linnaeus_tpu_torch.ops import fused_dwconv_mlp as fb
from linnaeus_tpu_torch.ops import fused_mlp as fm
from linnaeus_tpu_torch.ops.kernel_bars import BWD_TOL, K1_TOL, K2_TOL, SCALE_ADD_TOL
from linnaeus_tpu_torch.ops.kernel_bars import max_err as _max_err
from linnaeus_tpu_torch.ops.kernel_bars import rel_err as _rel_err

pytestmark = pytest.mark.cuda

# the shapes of K2's calls in a train step of mFormerV1_sm at 384 px, B = 128
K2_CELL_SHAPES = [(128 * 96 * 96, 96), (128 * 48 * 48, 192)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 37, 130])
def test_k1_matches_plain_on_strided_views(dev, dtype, n):
    g = torch.Generator(device=dev).manual_seed(n)
    q, k, v = torch.randn(2, n, 3, 3, 64, generator=g, device=dev).to(dtype).unbind(2)
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v, scale=0.2)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, scale=0.2)
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    assert _max_err(out, ref) <= K1_TOL[dtype]
    assert _max_err(lse, ref_lse) <= K1_TOL[dtype]


def test_k1_rejects_what_it_does_not_take(dev):
    q = torch.randn(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q, q)  # head dim 32
    q = torch.randn(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, q.bfloat16(), q)


@pytest.mark.parametrize("dtype,M,C", [(dtype, 70, C) for dtype in (torch.float32, torch.bfloat16)
                                         for C in (16, 40, 96, 192)]
                         + [(dtype, M, C) for dtype in (torch.float32, torch.bfloat16)
                            for M, C in K2_CELL_SHAPES]
                         + [(torch.float32, 150 * 64, 192)])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("approximate", [True, False])
def test_k2_matches_plain(dev, dtype, M, C, residual, approximate):
    """A whole 64-row tile and a ragged one, and the stages' rows of a
    train step at B = 128, where every persistent block of the tensor-core
    forward takes several row tiles. The same bits twice."""
    g = torch.Generator(device=dev).manual_seed(C)
    y, x = (torch.randn(M, C, generator=g, device=dev).to(dtype) for _ in range(2))
    vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
    w1 = (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dtype)
    w2 = (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dtype)
    args = (y, x if residual else None, vec(C, 0.1, 1.0), vec(C, 0.1), w1,
            vec(4 * C, 0.1), w2, vec(C, 0.1), vec(C, 0.1, 0.5))
    before = fm.LAUNCHES
    out = fm.fused_convnext_mlp(*args, approximate_gelu=approximate)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == before + 1
    ref = fm.fused_convnext_mlp_reference(*args, 1e-6, approximate)
    assert torch.isfinite(out).all()
    assert _max_err(out, ref) <= K2_TOL[dtype]
    assert torch.equal(out, fm.fused_convnext_mlp(*args, approximate_gelu=approximate))


def test_k2_rejects_what_it_does_not_take(dev):
    C = fm.MAX_WIDTH + 8
    y = torch.randn(4, C, device=dev)
    w = torch.randn(4 * C, C, device=dev)
    with pytest.raises(ValueError):
        fm.fused_convnext_mlp(y, None, torch.ones(C, device=dev), torch.zeros(C, device=dev),
                              w, torch.zeros(4 * C, device=dev), w.t().contiguous(),
                              torch.zeros(C, device=dev), None)


def _k2_args(dev, M, C, dtype, seed=None, hidden=None):
    g = torch.Generator(device=dev).manual_seed(C if seed is None else seed)
    Hd = 4 * C if hidden is None else hidden
    y, x = (torch.randn(M, C, generator=g, device=dev).to(dtype) for _ in range(2))
    vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
    w1 = (0.1 * torch.randn(Hd, C, generator=g, device=dev)).to(dtype)
    w2 = (0.1 * torch.randn(C, Hd, generator=g, device=dev)).to(dtype)
    return [y, x, vec(C, 0.1, 1.0), vec(C, 0.1), w1, vec(Hd, 0.1), w2, vec(C, 0.1),
            vec(C, 0.1, 0.5)]


@pytest.mark.parametrize("M", [1, 63, 64, 65, 128, 129, 200, 64 * 150 + 7, 64 * 1000 + 7])
@pytest.mark.parametrize("C", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("residual,approximate", [(True, True), (False, True), (True, False)])
def test_k2_bf16_tensor_core_forward_matches_plain(dev, M, C, residual, approximate):
    """Around the 64-row tile edges (and past one block's rows), at every
    half atom of width, the same bits twice."""
    dtype = torch.bfloat16
    assert fm.forward_kernel(C, dtype) == "wgmma"
    args = _k2_args(dev, M, C, dtype, seed=M + C)
    if not residual:
        args[1] = None
    before = fm.LAUNCHES
    out = fm.fused_convnext_mlp(*args, approximate_gelu=approximate)
    again = fm.fused_convnext_mlp(*args, approximate_gelu=approximate)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == before + 2
    ref = fm.fused_convnext_mlp_reference(*args, 1e-6, approximate)
    assert out.shape == (M, C) and out.dtype == dtype and torch.isfinite(out).all()
    assert _max_err(out, ref) <= K2_TOL[dtype]
    assert torch.equal(out, again)


@pytest.mark.parametrize("hidden", [64, 192, 320])
def test_k2_bf16_tensor_core_forward_takes_any_whole_hidden_chunks(dev, hidden):
    """One chunk, an odd number of chunks, and a hidden width that is not 4C."""
    args = _k2_args(dev, 150, 96, torch.bfloat16, hidden=hidden)
    assert fm.forward_kernel(96, torch.bfloat16, hidden) == "wgmma"
    out = fm.fused_convnext_mlp(*args)
    torch.cuda.synchronize()
    want = fm.fused_convnext_mlp_reference(*args, 1e-6, True)
    assert _max_err(out, want) <= K2_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 32, 40, 64, 96, 128, 160, 192, 224, 256])
def test_forward_routes_reported_by_the_library_are_the_python_rules(dev, dtype, C):
    from linnaeus_tpu_torch import _kernels

    lib, code = _kernels.library(), _kernels.DTYPE_CODES[dtype]
    for hidden in (4 * C, 4 * C + 8):
        reported = lib.lt_fused_mlp_fwd_route(C, hidden, code)
        assert fm.KERNELS[1 - reported] == fm.forward_kernel(C, dtype, hidden)
        reported = lib.lt_fused_convnext_block_fwd_route(C, hidden, code)
        assert fm.KERNELS[1 - reported] == fb.forward_kernel(C, dtype, hidden)
    wide = dtype == torch.bfloat16 and C % 32 == 0
    assert fm.forward_kernel(C, dtype) == ("wgmma" if wide else "cuda_cores")
    assert fb.forward_kernel(C, dtype) == ("wgmma" if wide and C <= 192 else "cuda_cores")


def test_k2_bf16_rejects_a_misaligned_operand(dev):
    args = _k2_args(dev, 64, 96, torch.bfloat16)
    flat = torch.zeros(64 * 96 + 8, dtype=torch.bfloat16, device=dev)
    args[0] = flat[1:1 + 64 * 96].view(64, 96)  # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="y is misaligned"):
        fm.fused_convnext_mlp(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [96, 192, 256, 384, 512])
@pytest.mark.parametrize("train", [False, True])
def test_block_left_to_choose_runs_at_every_preset_width(dev, dtype, dim, train):
    """``ConvNeXtBlock(dim, fused_mlp=None)`` forward, and forward and
    backward, at the widths of the sm, lg (192, 384) and xl (256, 512)
    presets: through K2 where ``kernel_takes`` says so, through the plain
    modules past it, and agreeing with the plain modules either way."""
    from linnaeus_tpu_torch.models.blocks.convnext import ConvNeXtBlock

    torch.manual_seed(dim)
    block = ConvNeXtBlock(dim, layer_scale_init_value=0.5).to(dev)
    plain = ConvNeXtBlock(dim, layer_scale_init_value=0.5, fused_mlp=False).to(dev)
    plain.load_state_dict(block.state_dict())
    x = torch.randn(2, 9, 10, dim, device=dev).to(dtype)
    before = (fm.LAUNCHES, fm.BWD_LAUNCHES)
    with torch.set_grad_enabled(train):  # the layers cast their float32 weights to x's dtype
        out, ref = block(x), plain(x)
        if train:
            out.float().square().sum().backward()
            ref.float().square().sum().backward()
    torch.cuda.synchronize()
    took = fm.kernel_takes(dim, out.dtype, needs_grad=train)
    assert (fm.LAUNCHES - before[0], fm.BWD_LAUNCHES - before[1]) == (
        int(took), int(took and train))
    assert _max_err(out, ref) <= 2 * K2_TOL[dtype] + 1e-4
    if train:
        for (name, p), q in zip(block.named_parameters(), plain.parameters()):
            assert _rel_err(p.grad, q.grad) <= 10 * BWD_TOL[dtype], name


@pytest.mark.parametrize("dim", [288, 384, 512])
def test_block_told_to_fuse_past_the_kernels_widths_raises_by_name(dev, dim):
    from linnaeus_tpu_torch.models.blocks.convnext import ConvNeXtBlock

    block = ConvNeXtBlock(dim, fused_mlp=True).to(dev)
    with torch.no_grad(), pytest.raises(ValueError, match=f"C={dim}"):
        block(torch.randn(1, 8, 8, dim, device=dev))
    wide = ConvNeXtBlock(256, fused_mlp=True).to(dev)  # the forward takes it, the backward not
    out = wide(torch.randn(1, 8, 8, 256, device=dev))
    with pytest.raises(ValueError, match="C=256"):
        out.sum().backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 37, 3), (2, 130, 3), (4, 580, 6), (4, 148, 12)])
def test_k1_backward_matches_plain_on_strided_views(dev, dtype, shape):
    B, n, H = shape
    g = torch.Generator(device=dev).manual_seed(n)
    qkv = torch.randn(B, n, 3, H, 64, generator=g, device=dev).to(dtype).requires_grad_()
    q, k, v = qkv.unbind(2)
    do = torch.randn(B, n, H, 64, generator=g, device=dev).to(dtype)
    before = fa.BWD_LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v, scale=0.2)
    out.backward(do)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    ref = fa.flash_attention_bwd_reference(q, k, v, out.detach(), lse, do, 0.2)
    assert qkv.grad.shape == qkv.shape and qkv.grad.dtype == dtype
    for name, got, want in zip("qkv", qkv.grad.unbind(2), ref):
        assert torch.isfinite(got).all(), name
        assert _rel_err(got, want) <= BWD_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 37, 3), (2, 130, 3), (3, 1028, 2), (1, 1100, 1)])
def test_k1_split_backward_matches_plain_on_strided_views(dev, dtype, shape):
    """The backward through autograd: the delta prologue, the dQ kernel and
    the dK/dV kernel against their plain versions; dQ the same bits twice."""
    B, n, H = shape
    g = torch.Generator(device=dev).manual_seed(n)
    qkv = torch.randn(B, n, 3, H, 64, generator=g, device=dev).to(dtype).requires_grad_()
    q, k, v = qkv.unbind(2)
    do = torch.randn(B, n, H, 64, generator=g, device=dev).to(dtype)
    before = (fa.BWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    out, lse = fa.flash_attention_fwd(q, k, v, scale=0.2)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.BWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    delta = fa.attention_delta(out.detach(), do)
    assert _rel_err(fa._launch_delta(out.detach(), do), delta) <= BWD_TOL[dtype]
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, 0.2)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, 0.2)
    assert qkv.grad.shape == qkv.shape and qkv.grad.dtype == dtype
    for name, got, want in zip("qkv", qkv.grad.unbind(2), (want_dq, want_dk, want_dv)):
        assert torch.isfinite(got).all(), name
        assert _rel_err(got, want) <= BWD_TOL[dtype], name
    again = fa._launch_bwd_dq(q.detach(), k.detach(), v.detach(), do, lse, delta, 0.2)
    assert torch.equal(again, fa._launch_bwd_dq(q.detach(), k.detach(), v.detach(), do, lse,
                                                delta, 0.2))


# ---------------------------------------------- K1 bf16 on the tensor cores
# every K1 shape of the model at 384 and 512 px (batch cut to 2: a block
# sees one (b, h)), the rollout's one image, and sequence lengths around the
# 64-row tile edges
K1_SMOKE_SHAPES = [(2, 580, 6), (2, 148, 12), (2, 37, 3), (2, 1028, 6), (2, 260, 12),
                   (1, 580, 6), (1, 148, 12)]
K1_EDGE_SHAPES = [(2, n, 2) for n in (1, 63, 64, 65, 127, 129)]


def _k1_operands(dev, shape, layout, dtype=torch.bfloat16):
    """q, k, v as the three slices of one qkv tensor or as contiguous
    tensors, and a contiguous dO."""
    B, n, H = shape
    g = torch.Generator(device=dev).manual_seed(n + H)
    qkv = torch.randn(B, n, 3, H, 64, generator=g, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    do = torch.randn(B, n, H, 64, generator=g, device=dev).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("layout", ["qkv_slices", "contiguous"])
@pytest.mark.parametrize("shape", K1_SMOKE_SHAPES + K1_EDGE_SHAPES)
def test_k1_bf16_tensor_core_forward_matches_plain(dev, shape, layout):
    q, k, v, _ = _k1_operands(dev, shape, layout)
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _max_err(out, ref) <= K1_TOL[torch.bfloat16]
    assert _max_err(lse, ref_lse) <= K1_TOL[torch.bfloat16]


@pytest.mark.parametrize("layout", ["qkv_slices", "contiguous"])
@pytest.mark.parametrize("shape", K1_SMOKE_SHAPES + K1_EDGE_SHAPES)
def test_k1_bf16_tensor_core_backward_matches_plain(dev, shape, layout):
    """The backward, and its dK/dV kernel launched alone, against their
    plain versions (the one-pass one and the dK/dV one); dQ, dK and dV of
    the kernels alone the backward's bits."""
    q, k, v, do = _k1_operands(dev, shape, layout)
    scale = 0.125
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    before = (fa.BWD_LAUNCHES, fa.DKV_LAUNCHES)
    dq, dk, dv = fa._launch_bwd(q, k, v, o, lse, do, scale)
    delta = fa._launch_delta(o, do)
    dk_split, dv_split = fa._launch_bwd_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert (fa.BWD_LAUNCHES, fa.DKV_LAUNCHES) == (before[0] + 1, before[1] + 2)
    assert torch.equal(fa._launch_bwd_dq(q, k, v, do, lse, delta, scale), dq)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, fa.attention_delta(o, do), scale)
    # relative to each gradient's largest magnitude, but no less than 1e-3:
    # with one key P is 1 and dQ and dK are zero in exact arithmetic
    for name, got, ref in zip(("dq", "dk", "dv", "dk (dK/dV kernel)", "dv (dK/dV kernel)"),
                              (dq, dk, dv, dk_split, dv_split), want + (want_dk, want_dv)):
        assert torch.isfinite(got).all(), name
        bar = BWD_TOL[torch.bfloat16] * max(ref.float().abs().max().item(), 1e-3)
        assert _max_err(got, ref) <= bar, name
    assert torch.equal(dk_split, dk) and torch.equal(dv_split, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_SMOKE_SHAPES + K1_EDGE_SHAPES)
def test_k1_backward_is_the_same_bits_twice(dev, dtype, shape):
    """dQ is summed over the key tiles in order by the block that owns the
    query tile, and dK, dV over the query tiles by the block that owns the
    key tile, so two calls on the same operands give dQ, dK and dV equal bit
    for bit."""
    q, k, v, do = _k1_operands(dev, shape, "qkv_slices")
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    o, lse = fa.flash_attention_fwd(q, k, v, 0.125)
    first = [t.clone() for t in fa._launch_bwd(q, k, v, o, lse, do, 0.125)]
    second = fa._launch_bwd(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shape", [(2, 37, 3), (2, 130, 3), (2, 580, 6), (2, 148, 12),
                                   (2, 1028, 6), (2, 260, 12)])
def test_k1_float32_stays_on_the_cuda_cores_at_its_bar(dev, shape):
    """float32 takes kernels that compute in float32 throughout: a
    tensor-core product (TF32 keeps ten mantissa bits) would miss 2e-5."""
    q, k, v, do = _k1_operands(dev, shape, "qkv_slices", torch.float32)
    out, lse = fa.flash_attention_fwd(q, k, v)
    ref, ref_lse = fa.flash_attention_reference(q, k, v)
    assert _max_err(out, ref) <= K1_TOL[torch.float32]
    assert _max_err(lse, ref_lse) <= K1_TOL[torch.float32]
    got = fa._launch_bwd(q, k, v, out, lse, do, 0.125)
    delta = fa._launch_delta(out, do)
    dk, dv = fa._launch_bwd_dkv(q, k, v, do, lse, delta, 0.125)
    dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, 0.125)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, 0.125)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(a, b) <= BWD_TOL[torch.float32], name
    assert torch.equal(dq, got[0]) and torch.equal(dk, got[1]) and torch.equal(dv, got[2])


K1_DQ_EDGE_SHAPES = [(2, n, 2) for n in (1, 63, 64, 65, 130, 580, 1028, 1100)]


@pytest.mark.parametrize("layout", ["qkv_slices", "contiguous"])
@pytest.mark.parametrize("shape", K1_DQ_EDGE_SHAPES)
def test_k1_bf16_tensor_core_dq_matches_plain(dev, shape, layout):
    """The split pair's dQ kernel around the 64-row tile edges, written into
    the dq slice of a (B, N, 3, H, D) buffer or a contiguous tensor; the same
    bits from two launches."""
    q, k, v, do = _k1_operands(dev, shape, layout)
    scale = 0.125
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    delta = fa._launch_delta(o, do)
    out = fa._grad_buffer(q)[0] if layout == "qkv_slices" else None
    before = fa.DQ_LAUNCHES
    dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, scale, out=out)
    again = fa._launch_bwd_dq(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert fa.DQ_LAUNCHES == before + 2
    want = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, fa.attention_delta(o, do),
                                               scale)
    assert torch.isfinite(dq).all()
    bar = BWD_TOL[torch.bfloat16] * max(want.float().abs().max().item(), 1e-3)
    assert _max_err(dq, want) <= bar
    assert torch.equal(dq, again)


@pytest.mark.parametrize("shape", [(2, 37, 3), (2, 130, 3), (1, 1028, 2)])
def test_k1_float32_dq_stays_on_the_cuda_cores_at_its_bar(dev, shape):
    q, k, v, do = _k1_operands(dev, shape, "qkv_slices", torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v, 0.125)
    delta = fa._launch_delta(o, do)
    dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, 0.125)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, 0.125)
    assert _rel_err(dq, want) <= BWD_TOL[torch.float32]


def test_k1_bf16_rejects_misaligned_views_and_copies_a_misaligned_dout(dev):
    B, n, H, D = 2, 70, 2, 64
    flat = torch.randn(B * n * H * D + 4, device=dev).bfloat16()
    bad = flat[4:].view(B, n, H, D)  # starts 8 bytes into a 16-byte line
    good = bad.clone()
    assert fa.misalignment(bad) is not None and fa.misalignment(good) is None
    with pytest.raises(ValueError, match="misaligned"):
        fa.flash_attention_fwd(bad, good, good)
    with pytest.raises(ValueError, match="misaligned"):
        fa.flash_attention_fwd(good, good, bad)
    # float32 kernels read element by element: the same view is taken
    out32, _ = fa.flash_attention_fwd(bad.float(), bad.float(), bad.float())
    assert torch.isfinite(out32).all()
    # a misaligned dO is copied onto a 16-byte line
    x = good.clone().requires_grad_()
    out = fa.flash_attention(x, x, x)
    out.backward(bad)
    aligned = good.clone().requires_grad_()
    fa.flash_attention(aligned, aligned, aligned).backward(bad.clone())
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all()
    assert _rel_err(x.grad, aligned.grad) <= BWD_TOL[torch.bfloat16]


def test_k1_auto_route_takes_the_split_kernels_past_1024_tokens(dev):
    """Past 1024 tokens, where the TPU package takes its split pair, and
    below, where it takes its one-pass kernel: one backward call, one dQ and
    one dK/dV launch."""
    counts = []
    for n in (1024, 1025):
        qkv = torch.randn(1, n, 3, 1, 64, device=dev, requires_grad=True)
        before = (fa.BWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        fa.flash_attention(*qkv.unbind(2)).sum().backward()
        after = (fa.BWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        counts.append(tuple(a - b for a, b in zip(after, before)))
    assert counts == [(1, 1, 1), (1, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 7, 16), (2, 9, 11, 40), (1, 8, 8, 96), (3, 13, 17, 96),
                                   (2, 10, 23, 192), (2, 7, 9, 32), (1, 16, 24, 64),
                                   (2, 17, 8, 128), (1, 9, 9, 160), (2, 24, 24, 192)])
@pytest.mark.parametrize("approximate", [True, False])
def test_k3_matches_plain(dev, dtype, shape, approximate):
    B, H, W, C = shape
    g = torch.Generator(device=dev).manual_seed(C + H)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    x = randn(B, H, W, C).to(dtype)
    args = (0.2 * randn(C, 1, 7, 7), 0.1 * randn(C), 1.0 + 0.1 * randn(C), 0.1 * randn(C),
            (0.1 * randn(4 * C, C)).to(dtype), 0.1 * randn(4 * C),
            (0.1 * randn(C, 4 * C)).to(dtype), 0.1 * randn(C), 0.5 + 0.1 * randn(C))
    before = fb.LAUNCHES
    out = fb.fused_convnext_block(x, *args, approximate_gelu=approximate)
    torch.cuda.synchronize()
    assert fb.LAUNCHES == before + 1
    ref = fb.fused_convnext_block_reference(x, *args, 1e-6, approximate)
    assert out.shape == x.shape and out.dtype == dtype
    assert _max_err(out, ref) <= K2_TOL[dtype]
    # the production route computes the same block: library conv, then K2
    chain = fb.convnext_block_chain(x, *args, 1e-6, approximate)
    assert _max_err(out, chain) <= 2 * K2_TOL[dtype] + 1e-4


def test_k3_backward_recomputes_the_plain_chain(dev):
    B, H, W, C = 2, 9, 8, 16
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    leaves = [t.requires_grad_() for t in (
        randn(B, H, W, C), 0.2 * randn(C, 1, 7, 7), 0.1 * randn(C), 1.0 + 0.1 * randn(C),
        0.1 * randn(C), 0.1 * randn(4 * C, C), 0.1 * randn(4 * C), 0.1 * randn(C, 4 * C),
        0.1 * randn(C), 0.5 + 0.1 * randn(C))]
    before = fb.LAUNCHES
    fb.fused_convnext_block(*leaves).square().sum().backward()
    assert fb.LAUNCHES == before + 1
    got = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    fb.convnext_block_chain(*leaves, 1e-6, True).square().sum().backward()
    for i, (a, t) in enumerate(zip(got, leaves)):
        assert _rel_err(a, t.grad) <= 1e-4, i


def test_k3_rejects_what_it_does_not_take(dev):
    def args(C, H=8, W=8, dtype=torch.float32):
        return (torch.randn(1, H, W, C, device=dev, dtype=dtype),
                torch.randn(C, 1, 7, 7, device=dev), torch.zeros(C, device=dev),
                torch.ones(C, device=dev), torch.zeros(C, device=dev),
                torch.randn(4 * C, C, device=dev, dtype=dtype), torch.zeros(4 * C, device=dev),
                torch.randn(C, 4 * C, device=dev, dtype=dtype), torch.zeros(C, device=dev), None)

    with pytest.raises(ValueError, match="width"):
        fb.fused_convnext_block(*args(fb.MAX_WIDTH + 8))
    with pytest.raises(ValueError, match="at least 7"):
        fb.fused_convnext_block(*args(16, H=6))
    with pytest.raises(TypeError):
        fb.fused_convnext_block(*args(16, dtype=torch.float16))
    mixed = list(args(16))
    mixed[5] = mixed[5].bfloat16()
    with pytest.raises(ValueError, match="w1"):
        fb.fused_convnext_block(*mixed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C", [(70, 16), (70, 40), (1000, 96), (300, 192), (64 * 150, 96),
                                 (1000, 32), (64 * 150 + 7, 64), (64 * 150 + 7, 96),
                                 (1000, 128), (64 * 150 + 7, 192), (1000, 160)]
                         + K2_CELL_SHAPES)
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("approximate", [True, False])
def test_k2_backward_matches_plain(dev, dtype, M, C, residual, approximate):
    g = torch.Generator(device=dev).manual_seed(C)
    y, x, dout = (torch.randn(M, C, generator=g, device=dev).to(dtype) for _ in range(3))
    vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
    w1 = (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dtype)
    w2 = (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dtype)
    params = [vec(C, 0.1, 1.0), vec(C, 0.1), w1, vec(4 * C, 0.1), w2, vec(C, 0.1),
              vec(C, 0.1, 0.5)]
    leaves = [t.requires_grad_() for t in [y, x] + params]
    before = fm.BWD_LAUNCHES
    out = fm.fused_convnext_mlp(leaves[0], leaves[1] if residual else None, *leaves[2:],
                                approximate_gelu=approximate)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fm.BWD_LAUNCHES == before + 1
    want = fm.fused_convnext_mlp_bwd_reference(
        y.detach(), dout, *(t.detach() for t in params), 1e-6, approximate)
    got = [leaves[0].grad] + [t.grad for t in leaves[2:]]
    names = ("dy", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        # the weight gradients come back in the weights' dtype
        assert _rel_err(a, b.to(a.dtype)) <= BWD_TOL[dtype], name
    if residual:
        assert torch.equal(leaves[1].grad, dout)
    else:
        assert leaves[1].grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 32, 40, 64, 96, 128, 160, 192])
def test_k2_backward_route_reported_by_the_library_is_the_python_rule(dev, dtype, C):
    from linnaeus_tpu_torch import _kernels

    for hidden in (4 * C, 4 * C + 8):
        reported = _kernels.library().lt_fused_mlp_bwd_route(C, hidden, _kernels.DTYPE_CODES[dtype])
        assert fm.BWD_KERNELS[1 - reported] == fm.backward_kernel(C, dtype, hidden)
    wide = dtype == torch.bfloat16 and C % 32 == 0
    assert fm.backward_kernel(C, dtype) == ("wgmma" if wide else "cuda_cores")


@pytest.mark.parametrize("M,C", K2_CELL_SHAPES)
@pytest.mark.parametrize("approximate", [True, False])
def test_k2_bf16_backward_matches_plain_at_the_train_steps_shapes(dev, M, C, approximate):
    args = _k2_args(dev, M, C, torch.bfloat16, seed=M + C)
    y, x, ln_w, ln_b, w1, b1, w2, b2, gamma = args
    before = fm.BWD_LAUNCHES
    got = fm._launch_bwd(y, x, ln_w, ln_b, w1, b1, w2, b2, gamma, 1e-6, approximate)
    torch.cuda.synchronize()
    assert fm.BWD_LAUNCHES == before + 1
    want = fm.fused_convnext_mlp_bwd_reference(y, x, ln_w, ln_b, w1, b1, w2, b2, gamma, 1e-6,
                                               approximate)
    names = ("dy", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= BWD_TOL[torch.bfloat16], name


@pytest.mark.parametrize("C", [96, 192])
@pytest.mark.parametrize("hidden", [64, 192, 320])
def test_k2_bf16_backward_takes_any_whole_hidden_chunks(dev, C, hidden):
    """Hidden widths of one, three and five 64-column chunks: the weight
    pass's blocks of one chunk each, an odd count of them included."""
    args = _k2_args(dev, 64 * 150 + 7, C, torch.bfloat16, hidden=hidden)
    y, x, ln_w, ln_b, w1, b1, w2, b2, gamma = args
    got = fm._launch_bwd(y, x, ln_w, ln_b, w1, b1, w2, b2, gamma, 1e-6, True)
    torch.cuda.synchronize()
    want = fm.fused_convnext_mlp_bwd_reference(y, x, ln_w, ln_b, w1, b1, w2, b2, gamma, 1e-6,
                                               True)
    for name, a, b in zip(("dy", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma"),
                          got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[torch.bfloat16], name


def test_k2_backward_build_keeps_every_wgmma_asynchronous(dev):
    """ptxas's report on the tensor-core backward's source names no
    serialised `wgmma` (C7520 and its kin: a product issued on a path it
    takes for divergent, too few registers for the pipeline)."""
    from linnaeus_tpu_torch import _kernels

    # the file's functions carry its name in their mangled names
    report = [line for line in _kernels.resource_usage().splitlines()
              if "fused_mlp_bwd_wgmma_cu" in line]
    assert any("mlp_bwd_rows_wgmma_kernel" in line for line in report)
    assert any("mlp_bwd_weights_wgmma_kernel" in line for line in report)
    assert not [line for line in report if "C7520" in line]
    serialised = [line for line in report
                  if "wgmma.mma_async instructions are serialized" in line]
    assert not serialised, serialised


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C", [(1000, 96), (64 * 150 + 7, 192), (70, 40)] + K2_CELL_SHAPES)
def test_k2_backward_is_the_same_bits_twice(dev, dtype, M, C):
    g = torch.Generator(device=dev).manual_seed(C)
    y, dout = (torch.randn(M, C, generator=g, device=dev).to(dtype) for _ in range(2))
    vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
    w1 = (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dtype)
    w2 = (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dtype)
    args = (y, dout, vec(C, 0.1, 1.0), vec(C, 0.1), w1, vec(4 * C, 0.1), w2, vec(C, 0.1),
            vec(C, 0.1, 0.5), 1e-6, True)
    first, second = fm._launch_bwd(*args), fm._launch_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_k2_backward_rejects_wide_rows(dev):
    C = fm.MAX_WIDTH_BWD + 16
    y = torch.randn(4, C, device=dev, requires_grad=True)
    w = torch.randn(4 * C, C, device=dev)
    out = fm.fused_convnext_mlp(y, None, torch.ones(C, device=dev), torch.zeros(C, device=dev),
                                w, torch.zeros(4 * C, device=dev), w.t().contiguous(),
                                torch.zeros(C, device=dev), None)
    with pytest.raises(ValueError):
        out.sum().backward()


def test_tiny_model_trains_kernels_on_vs_off(dev):
    """Loss and every parameter gradient of a tiny model, kernels on vs off;
    K1's backward launches its dQ and dK/dV kernels once a block."""
    spec = {
        "CONVNEXT": {"DEPTHS": [2, 1, 1, 1], "DIMS": [16, 32, 128, 256]},
        "ROPE": {"DEPTHS": [1, 1], "DIMS": [128, 256], "NUM_HEADS": [2, 4]},
        "DROP_PATH_RATE": 0.0,
    }
    nc = {"taxa_L10": 11, "taxa_L20": 5}
    meta = (("TEMPORAL", 2), ("SPATIAL", 3))
    on = build_model(spec, 64, nc, meta, use_flash_attn=True, device=dev).train()
    off = build_model(spec, 64, nc, meta, use_flash_attn=False, fused_convnext_mlp=False,
                      device=dev).train()
    with torch.no_grad():  # the layer scale's 1e-6 would hide the MLP tail
        for net in (on, off):
            for blk in list(net.stages[0]) + list(net.stages[1]):
                blk.gamma.fill_(0.5)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, 64, 64, 3)).astype(np.float32), device=dev)
    m = torch.tensor(rng.normal(size=(3, 5)).astype(np.float32), device=dev)
    def counters():
        return (fa.LAUNCHES, fa.BWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES,
                fm.LAUNCHES, fm.BWD_LAUNCHES)

    counts = counters()
    losses = []
    for net in (on, off):
        out = net(x, m)
        loss = sum(out[t].square().mean() for t in nc)
        loss.backward()
        losses.append(loss.item())
    launched = tuple(a - b for a, b in zip(counters(), counts))
    assert launched == (2, 2, 2, 2, 3, 3)
    assert abs(losses[0] - losses[1]) <= 1e-5 * max(1.0, abs(losses[1]))
    # a gradient that is zero in exact arithmetic (the bias in front of the
    # aggregation's softmax) is float32 noise on both routes: hold each
    # parameter to 1e-3 of its own scale plus 1e-6 of the largest gradient
    floor = 1e-6 * max(r.grad.abs().max().item() for r in off.parameters())
    for (name, p), (_, r) in zip(on.named_parameters(), off.named_parameters()):
        assert p.grad is not None, name
        assert _max_err(p.grad, r.grad) <= 1e-3 * r.grad.abs().max().item() + floor, name


def test_tiny_model_kernels_on_vs_off(dev):
    spec = {
        "CONVNEXT": {"DEPTHS": [2, 1, 1, 1], "DIMS": [16, 32, 128, 256]},
        "ROPE": {"DEPTHS": [1, 1], "DIMS": [128, 256], "NUM_HEADS": [2, 4]},
        "DROP_PATH_RATE": 0.0,
    }
    nc = {"taxa_L10": 11, "taxa_L20": 5}
    meta = (("TEMPORAL", 2), ("SPATIAL", 3))
    on = build_model(spec, 64, nc, meta, use_flash_attn=True, device=dev)
    off = build_model(spec, 64, nc, meta, use_flash_attn=False, fused_convnext_mlp=False,
                      device=dev)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, 64, 64, 3)).astype(np.float32), device=dev)
    m = torch.tensor(rng.normal(size=(3, 5)).astype(np.float32), device=dev)
    k1, k2 = fa.LAUNCHES, fm.LAUNCHES
    with torch.inference_mode():
        a, b = on(x, m), off(x, m)
    assert (fa.LAUNCHES - k1, fm.LAUNCHES - k2) == (2, 3)
    for t in nc:
        assert _max_err(a[t], b[t]) <= 1e-4


REMAT_SPEC = {
    "CONVNEXT": {"DEPTHS": [2, 1, 1, 1], "DIMS": [96, 192, 128, 256]},
    "ROPE": {"DEPTHS": [1, 1], "DIMS": [128, 256], "NUM_HEADS": [2, 4]},
    "DROP_PATH_RATE": 0.2,
}
REMAT_NC = {"taxa_L10": 11, "taxa_L20": 5}


def _remat_run(dev, dtype, remat, policy):
    """Gradients of a training step of a small model with K1 and K2 on and
    drop path drawn from a seeded generator, with per-block checkpointing
    on or off; returns (gradients, launch counts)."""
    model = build_model(REMAT_SPEC, 64, REMAT_NC, (("TEMPORAL", 2),), dtype=dtype,
                        use_flash_attn=True, fused_convnext_mlp=None, device=dev, seed=1)
    model.gradient_checkpointing, model.remat_policy = remat, policy
    gen = torch.Generator(device=dev).manual_seed(3)
    for m in model.modules():
        if hasattr(m, "rate"):
            m.generator = gen
    model.train()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(size=(3, 64, 64, 3)).astype(np.float32), device=dev)
    meta = torch.tensor(rng.normal(size=(3, 2)).astype(np.float32), device=dev)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES, fm.LAUNCHES, fm.BWD_LAUNCHES)
    out = model(x, meta)
    sum(v.square().mean() for v in out.values()).backward()
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip((fa.LAUNCHES, fa.BWD_LAUNCHES, fm.LAUNCHES,
                                          fm.BWD_LAUNCHES), before))
    return {n: p.grad.float() for n, p in model.named_parameters()}, counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_kernels_under_checkpoint_give_the_same_gradients(dev, dtype, policy):
    """K1 and K2 inside non-reentrant checkpoints, under each policy: the
    recompute relaunches each block's forward kernel once (the policies see
    no product inside a kernel), the backward kernels run once, and the
    gradients are those of the run without checkpointing, to the backward
    kernels' bars relative to each gradient's largest magnitude."""
    plain, n_plain = _remat_run(dev, dtype, False, policy)
    remat, n_remat = _remat_run(dev, dtype, True, policy)
    # 2 RoPE blocks (K1), 3 ConvNeXt blocks at 96 and 192 (K2)
    assert n_plain == (2, 2, 3, 3)
    assert n_remat == (4, 2, 6, 3)
    tol = BWD_TOL[dtype]
    for n in plain:
        scale = plain[n].abs().max().item()
        assert _max_err(remat[n], plain[n]) <= tol * scale + 1e-12, n


def test_recompute_takes_the_first_forwards_route(dev):
    """A ConvNeXt block left to choose takes K2's training route at C = 96
    and the plain modules at C = 256 (K2's backward stops at 192); its
    recompute, under checkpointing, takes the same route again."""
    from linnaeus_tpu_torch.models.blocks.convnext import ConvNeXtBlock
    from linnaeus_tpu_torch.models.utils import checkpoint_block, resolve_remat_policy

    for dim, want in ((96, (2, 1)), (256, (0, 0))):
        blk = ConvNeXtBlock(dim).to(dev).train()
        x = torch.randn(2, 12, 12, dim, device=dev, dtype=torch.bfloat16, requires_grad=True)
        before = (fm.LAUNCHES, fm.BWD_LAUNCHES)
        y = checkpoint_block(blk, x, True, context_fn=resolve_remat_policy("dots"))
        y.float().square().sum().backward()
        torch.cuda.synchronize()
        assert (fm.LAUNCHES - before[0], fm.BWD_LAUNCHES - before[1]) == want, dim


def test_gradnorm_norms_kernels_on_vs_off(dev):
    """The GradNorm update's per-task trunk norms with K1 and K2 on and off,
    on the same weights and batch, in bf16: within the backward kernels'
    bf16 bar."""
    from linnaeus_tpu_torch.loss import soft_target_cross_entropy
    from linnaeus_tpu_torch.loss.gradnorm import init_gradnorm_state, make_gradnorm_update_fn

    nets = [build_model(REMAT_SPEC, 64, REMAT_NC, (("TEMPORAL", 2),), dtype=torch.bfloat16,
                        use_flash_attn=k, fused_convnext_mlp=k, device=dev, seed=1)
            for k in (True, False)]
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(size=(4, 64, 64, 3)).astype(np.float32), device=dev)
    meta = torch.tensor(rng.normal(size=(4, 2)).astype(np.float32), device=dev)
    targets = {t: torch.eye(n, device=dev)[torch.arange(4, device=dev) % n]
               for t, n in REMAT_NC.items()}
    norms = []
    for net in nets:
        trunk = [n for n, _ in net.named_parameters() if not n.startswith(("head", "meta_"))]
        update = make_gradnorm_update_fn({t: soft_target_cross_entropy for t in REMAT_NC},
                                         tuple(REMAT_NC), trunk, alpha=1.5, remat=True)
        k1 = fa.LAUNCHES
        _, metrics = update(net, x, targets, meta, init_gradnorm_state(2, device=dev))
        norms.append(metrics["gradnorm/norms"])
        # two tasks, each a forward and its recompute through both RoPE blocks
        assert fa.LAUNCHES - k1 == (2 * 2 * 2 if net is nets[0] else 0)
    assert torch.isfinite(norms[0]).all()
    assert _max_err(norms[0], norms[1]) <= BWD_TOL[torch.bfloat16] * norms[1].abs().max().item()


def test_loader_copies_batches_to_the_card_on_a_side_stream(dev):
    """data/loader.py on the card: batches copied from pinned buffers on a
    side stream, the consumer's stream made to wait on each copy's event,
    equal the host batches; a kernel on the consumer's stream reads them
    before any host synchronisation."""
    from linnaeus_tpu_torch.data.datasets import PrefetchingDataset, SyntheticImageSource
    from linnaeus_tpu_torch.data.loader import H5DataLoader
    from linnaeus_tpu_torch.data.processor import ProcessedLabels
    from linnaeus_tpu_torch.data.sampler import GroupedBatchSampler

    n = 96
    rng = np.random.default_rng(0)
    labels = ProcessedLabels()
    labels.img_identifiers = [f"i{i}" for i in range(n)]
    labels.labels = {"t": rng.integers(0, 5, n).astype(np.int32)}
    labels.aux = rng.normal(size=(n, 5)).astype(np.float32)
    labels.group_ids = {"t": labels.labels["t"]}
    labels.valid_mask = np.ones(n, bool)

    def batches(device):
        loader = H5DataLoader(PrefetchingDataset(labels, SyntheticImageSource(64, seed=1), ["t"]),
                              GroupedBatchSampler(labels.group_ids, np.arange(n), 8,
                                                  mode="standard"),
                              device=device, device_prefetch_depth=2)
        loader.set_epoch(1)
        out = [{"sum": b["images"].sum(dtype=torch.int64), "batch": b} if device else b
               for b in loader]
        loader.close()
        return out

    host, on_card = batches(None), batches(dev)
    assert len(host) == len(on_card) == n // 8
    for h, c in zip(host, on_card):
        assert int(c["sum"]) == int(h["images"].astype(np.int64).sum())
        b = c["batch"]
        assert b["images"].device.type == "cuda" and b["images"].dtype == torch.uint8
        np.testing.assert_array_equal(b["images"].cpu().numpy(), h["images"])
        np.testing.assert_array_equal(b["targets"]["t"].cpu().numpy(), h["targets"]["t"])
        np.testing.assert_array_equal(b["aux"].cpu().numpy(), h["aux"])


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25])
def test_moe_mlp_on_the_card_matches_the_cpu(dev, capacity_factor):
    """models/blocks/moe.py on CUDA tensors (the stable sort, the slot
    scatter with its discarded row, the batched expert products) against the
    same module on the CPU in float32: output, statistics and gradients."""
    from linnaeus_tpu_torch.models.blocks.moe import MoEMlp

    g = torch.Generator().manual_seed(3)
    moe = MoEMlp(64, 128, num_experts=8, top_k=2, capacity_factor=capacity_factor,
                 generator=g)
    x = torch.randn(4, 37, 64, generator=g)
    outs = []
    for device in ("cpu", dev):
        m = copy.deepcopy(moe).to(device)
        xd = x.detach().to(device).requires_grad_(True)
        y, stats = m(xd)
        (y.square().sum() + stats.aux + 0.1 * stats.z).backward()
        outs.append([y, *stats, xd.grad] + [p.grad for p in m.parameters()])
    for a, b in zip(*outs):
        scale = max(a.abs().max().item(), 1e-6)
        assert _max_err(a, b.cpu()) <= 2e-5 * scale


def test_moe_model_trains_on_the_card_with_the_kernels(dev):
    """A tiny mFormerV1 with MoE blocks on K1 and K2, bf16 over float32
    parameters: the step's statistics come out finite and every bank and
    router gets a gradient."""
    model = build_model(dict(REMAT_SPEC, MOE={"NUM_EXPERTS": 4, "EVERY_N": 1}), 64,
                        {"t": 5}, (), dtype=torch.bfloat16, use_flash_attn=True,
                        fused_convnext_mlp=True, device=dev).train()
    x = torch.randn(2, 64, 64, 3, device=dev)
    out, stats = model(x, None, moe_stats=True)
    (out["t"].float().square().mean() + 0.01 * stats["moe_aux"]
     + 0.001 * stats["moe_z"]).backward()
    assert all(torch.isfinite(v) for v in stats.values())
    assert 0.0 <= float(stats["moe_drop_frac"]) < 1.0
    for name, p in model.named_parameters():
        if ".mlp." in name and name.rsplit(".", 1)[-1] in ("router", "wi", "wo"):
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, name


# ------------------------------------------------------------------ drop path


def _drop_scale(dev, B, seed, keep=0.9):
    """Seeded uniforms for B samples, every seventh sample dropped."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(B, generator=g, device=dev)
    u[::7] = 0.99
    return dpk.SampleScale(u, keep)


def _dropped(scale):
    return [b for b, kept in enumerate((scale.u < scale.keep).tolist()) if not kept]


def _k2_scaled_case(dev, dtype, M, C, B, approximate):
    args = _k2_args(dev, M, C, dtype, seed=M + C)
    y, x, params = args[0], args[1], args[2:]
    scale = _drop_scale(dev, B, seed=C)
    dout = torch.randn(M, C, generator=torch.Generator(device=dev).manual_seed(M),
                       device=dev).to(dtype)
    before = (fm.LAUNCHES, fm.BWD_LAUNCHES)
    out = fm._launch(y, x, *params, 1e-6, approximate, scale=scale)
    grads = fm._launch_bwd(y, dout, *params, 1e-6, approximate, scale=scale)
    torch.cuda.synchronize()
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = fm.fused_convnext_mlp_reference(y, x, *params, 1e-6, approximate, scale=scale)
    assert _max_err(out, want) <= K2_TOL[dtype]
    want_grads = fm.fused_convnext_mlp_bwd_reference(y, dout, *params, 1e-6, approximate,
                                                     scale=scale)
    names = ("dy", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma")
    for name, a, b in zip(names, grads, want_grads):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= BWD_TOL[dtype], name
    rows = M // B
    for b in _dropped(scale):  # a dropped sample: its residual, and no gradient to y
        assert torch.equal(out[b * rows:(b + 1) * rows], x[b * rows:(b + 1) * rows])
        assert not grads[0][b * rows:(b + 1) * rows].any()
    return out, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,B", [(140, 16, 2), (1000, 96, 8), (300, 192, 3), (960, 40, 15),
                                   (64 * 150, 64, 10)])
@pytest.mark.parametrize("approximate", [True, False])
def test_k2_scaled_matches_plain(dev, dtype, M, C, B, approximate):
    """Every route takes the scale: the tensor-core kernels in bf16 at
    widths of 32, the CUDA-core kernels for float32 and odd widths; samples
    of rows that are no multiple of a 64-row tile."""
    _k2_scaled_case(dev, dtype, M, C, B, approximate)


@pytest.mark.parametrize("M,C", K2_CELL_SHAPES)
def test_k2_scaled_matches_plain_at_the_train_steps_shapes(dev, M, C):
    """The train step's calls at B = 128: the forward and all eight
    gradients; two calls give the same bits."""
    out, grads = _k2_scaled_case(dev, torch.bfloat16, M, C, 128, True)
    again, grads_again = _k2_scaled_case(dev, torch.bfloat16, M, C, 128, True)
    assert torch.equal(out, again)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_again))


def test_k2_scaled_function_gives_dout_to_the_residual(dev):
    args = _k2_args(dev, 2 * 9 * 9, 96, torch.bfloat16)
    leaves = [t.requires_grad_() for t in args]
    y, x = (t.view(2, 9, 9, 96) for t in leaves[:2])
    scale = _drop_scale(dev, 2, seed=4)
    out = fm.fused_convnext_mlp(y, x, *leaves[2:], scale=scale)
    dout = torch.randn_like(out)
    out.backward(dout)
    assert torch.equal(leaves[1].grad, dout.view(-1, 96))
    with pytest.raises(ValueError, match="needs the residual"):
        fm.fused_convnext_mlp(y, None, *leaves[2:], scale=scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 580, 384), (128, 148, 768), (3, 7, 5), (9, 33),
                                   (20, 4, 6)])
def test_scale_add_matches_plain(dev, dtype, shape):
    """16-byte pieces where a sample's length allows (the RoPE blocks'
    shapes at B = 128), single elements otherwise; the backward is one
    rounding of s * dout, the same bits as the plain version's."""
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    residual, branch, dout = (torch.randn(shape, generator=g, device=dev).to(dtype)
                              for _ in range(3))
    scale = _drop_scale(dev, shape[0], seed=shape[1])
    before = (dpk.LAUNCHES, dpk.BWD_LAUNCHES)
    out = dpk._launch(residual, branch, scale)
    d_branch = dpk._launch_bwd(dout, scale)
    torch.cuda.synchronize()
    assert (dpk.LAUNCHES, dpk.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = dpk.scale_add_reference(residual, branch, scale)
    # one FMA against the plain version's product and sum
    assert _rel_err(out, want) <= SCALE_ADD_TOL[dtype]
    assert torch.equal(d_branch, dpk.scale_samples_reference(dout, scale))
    for b in _dropped(scale):
        assert torch.equal(out[b], residual[b]) and not d_branch[b].any()
    assert torch.equal(out, dpk._launch(residual, branch, scale))
    assert torch.equal(d_branch, dpk._launch_bwd(dout, scale))


def test_scale_add_rejects_what_it_does_not_take(dev):
    """``scale_add`` checks its operands once, before the launch."""
    x = torch.randn(4, 8, device=dev)
    scale = _drop_scale(dev, 4, seed=0)
    with pytest.raises(ValueError, match="draws"):
        dpk.scale_add(x, x, dpk.SampleScale(scale.u.cpu(), 0.9))
    with pytest.raises(ValueError, match="draws"):
        dpk.scale_add(x, x, dpk.SampleScale(scale.u[:3], 0.9))
    with pytest.raises(ValueError, match="differ"):
        dpk.scale_add(x, x.bfloat16(), scale)
    with pytest.raises(ValueError, match="differ"):
        dpk.scale_add(x, x.cpu(), scale)
    with pytest.raises(TypeError):
        dpk.scale_add(x.half(), x.half(), scale)
    wide = torch.zeros(dpk.MAX_SAMPLES + 1, 1, device=dev)
    with pytest.raises(ValueError, match="outside"):
        dpk.scale_add(wide, wide, _drop_scale(dev, dpk.MAX_SAMPLES + 1, seed=0))
    launched = dpk.LAUNCHES
    strided = torch.randn(8, 4, device=dev).t()  # made contiguous, then launched
    got = dpk.scale_add(strided, strided, _drop_scale(dev, 4, seed=1))
    assert dpk.LAUNCHES == launched + 1
    want = dpk.scale_add_reference(strided.contiguous(), strided.contiguous(),
                                   _drop_scale(dev, 4, seed=1))
    assert _rel_err(got, want) <= 1e-6


def test_tiny_model_under_drop_path_launches_both_kernels(dev):
    """A train step at rate 0.5: K2 forward and backward once a ConvNeXt
    block (the first at rate 0 without a scale), the scale-add kernel once
    a RoPE residual each way; two runs of one seed give the same bits."""
    spec = {
        "CONVNEXT": {"DEPTHS": [2, 1, 1, 1], "DIMS": [32, 64, 128, 256]},
        "ROPE": {"DEPTHS": [1, 1], "DIMS": [128, 256], "NUM_HEADS": [2, 4]},
        "DROP_PATH_RATE": 0.5,
    }
    nc = {"taxa_L10": 11}
    net = build_model(spec, 64, nc, (("TEMPORAL", 2),), dtype=torch.bfloat16,
                      use_flash_attn=True, device=dev).train()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(6, 64, 64, 3)).astype(np.float32), device=dev)
    m = torch.tensor(rng.normal(size=(6, 2)).astype(np.float32), device=dev)

    def step():
        gen = torch.Generator(device=dev).manual_seed(7)
        for mod in net.modules():
            if isinstance(mod, DropPath):
                mod.generator = gen
        net.zero_grad(set_to_none=True)
        loss = net(x, m)["taxa_L10"].float().square().mean()
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in net.parameters()]

    before = (fm.LAUNCHES, fm.BWD_LAUNCHES, dpk.LAUNCHES, dpk.BWD_LAUNCHES)
    first = step()
    torch.cuda.synchronize()
    took = tuple(a - b for a, b in zip(
        (fm.LAUNCHES, fm.BWD_LAUNCHES, dpk.LAUNCHES, dpk.BWD_LAUNCHES), before))
    assert took == (3, 3, 4, 4)
    second = step()
    assert torch.isfinite(first[0]) and torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


def test_tiny_model_with_its_kernels_off_launches_none_under_drop_path(dev):
    """K1 and K2 off (the train step's plain arm): the scaled residuals run
    in plain PyTorch, and neither K2 nor the scale-add kernel is launched;
    the gradients match the kernels' route."""
    spec = {
        "CONVNEXT": {"DEPTHS": [2, 1, 1, 1], "DIMS": [32, 64, 128, 256]},
        "ROPE": {"DEPTHS": [1, 1], "DIMS": [128, 256], "NUM_HEADS": [2, 4]},
        "DROP_PATH_RATE": 0.5,
    }
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(6, 64, 64, 3)).astype(np.float32), device=dev)
    m = torch.tensor(rng.normal(size=(6, 2)).astype(np.float32), device=dev)
    grads, launched = [], []
    for kernels in (True, False):
        net = build_model(spec, 64, {"taxa_L10": 11}, (("TEMPORAL", 2),), dtype=torch.float32,
                          use_flash_attn=kernels, fused_convnext_mlp=None if kernels else False,
                          device=dev, seed=3).train()
        gen = torch.Generator(device=dev).manual_seed(7)
        for mod in net.modules():
            if isinstance(mod, DropPath):
                mod.generator = gen
        before = (fm.LAUNCHES, fm.BWD_LAUNCHES, dpk.LAUNCHES, dpk.BWD_LAUNCHES)
        net(x, m)["taxa_L10"].float().square().mean().backward()
        torch.cuda.synchronize()
        launched.append(tuple(a - b for a, b in zip(
            (fm.LAUNCHES, fm.BWD_LAUNCHES, dpk.LAUNCHES, dpk.BWD_LAUNCHES), before)))
        grads.append([p.grad for p in net.parameters()])
    assert launched == [(3, 3, 4, 4), (0, 0, 0, 0)]
    # as test_tiny_model_trains_kernels_on_vs_off holds them
    floor = 1e-6 * max(r.abs().max().item() for r in grads[1])
    for a, b in zip(*grads):
        assert _max_err(a, b) <= 1e-3 * b.abs().max().item() + floor

