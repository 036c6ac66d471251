"""The bars the port's kernels are held to against their plain versions,
stated once. The card tests (``tests/test_torch_cuda.py``) hold every
kernel to them at the tile and length edges; ``chip_smoke.py``'s kernel
table holds each of its rows to them at the shapes the main path launches.

Forward outputs are held by their largest absolute difference, at the TPU
kernel tests' bars: K1 fp32 2e-5, bf16 3e-2; K2 (and K3, the fused ConvNeXt
block) fp32 1e-5, bf16 5e-2. Backward gradients are held relative to each
gradient's largest magnitude: fp32 2e-5 (another summation order), bf16
2e-2 (a rounding of P, dS, h1 or da1 that falls the other way moves a sum
by a bf16 step or two). The scale-add kernel's one FMA is held relative to
its largest output, within a rounding of the output's dtype, and its
backward is the plain version's bits.
"""

import math

import torch

K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCALE_ADD_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
EXACT = {torch.float32: 0.0, torch.bfloat16: 0.0}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_err(a, b) / max(b.float().abs().max().item(), 1e-12)


# each kernel by the name of its launch counter: its bars and their measure
_BY_KERNEL = {
    "K1": (K1_TOL, max_err),
    "K1_bwd": (BWD_TOL, rel_err),
    "K1_dq": (BWD_TOL, rel_err),
    "K1_dkv": (BWD_TOL, rel_err),
    "K2": (K2_TOL, max_err),
    "K2_bwd": (BWD_TOL, rel_err),
    "K3": (K2_TOL, max_err),
    "drop_path_add": (SCALE_ADD_TOL, rel_err),
    "drop_path_add_bwd": (EXACT, max_err),
}


def bar(kernel: str, dtype: torch.dtype) -> float:
    """The bar of ``kernel`` (a launch counter's name, as in ``_BY_KERNEL``)
    in ``dtype``."""
    return _BY_KERNEL[kernel][0][dtype]


def error(kernel: str, got, want) -> float:
    """The worst of ``kernel``'s outputs (a tensor or a tuple of them)
    against its plain version's, by the kernel's measure. A NaN anywhere
    makes it NaN, which no bar admits."""
    measure = _BY_KERNEL[kernel][1]
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    errs = [measure(a, b) for a, b in zip(got, want, strict=True)]
    return math.nan if any(math.isnan(e) for e in errs) else max(errs)
