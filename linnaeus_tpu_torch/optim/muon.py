"""Muon: momentum orthogonalised by a Newton-Schulz iteration.

Port of linnaeus_tpu/optim/muon.py (an optax transform there, a
``torch.optim.Optimizer`` here): SGD momentum in lerp form, optionally
Nesterov, then the quintic Newton-Schulz iteration on the update of every
matrix-like parameter, scaled by ``max(1, rows / cols) ** 0.5``, then
decoupled weight decay on every parameter and the learning rate. 1-D
parameters and matrices with a singleton dimension take the momentum alone.

Layout. The TPU package computes each update on its own layout of the
parameter and flattens a tensor of more than two dimensions to
``(shape[0], -1)``: a Dense kernel is (in, out) there and (out, in) here,
which changes the scale, and a depthwise kernel is (7, 7, 1, C) there,
flattened to (7, 7 C), and (C, 1, 7, 7) here. So each update is computed on
the Flax-layout view of the gradient (``utils/convert.py::jax_layouts``) and
mapped back, and the port orthogonalises the same matrices as JAX.

The iteration's products stay ``torch.matmul`` in bfloat16; the TPU package
computes them outside any kernel of its own too.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_DTYPE = torch.bfloat16  # the iteration's dtype


def zeropower_via_newtonschulz5(G: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Orthogonalise (zeroth matrix power) by the quintic Newton-Schulz
    iteration in bfloat16, the norm taken in float32; returns G's dtype."""
    assert G.dim() >= 2
    a, b, c = NS_COEFFS
    X = G.to(NS_DTYPE)
    transposed = G.shape[-2] > G.shape[-1]
    if transposed:
        X = X.transpose(-1, -2)
    norm = X.float().square().sum(dim=(-2, -1), keepdim=True).sqrt().to(NS_DTYPE)
    X = X / (norm + 1e-7)
    for _ in range(steps):
        A = X @ X.transpose(-1, -2)
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    if transposed:
        X = X.transpose(-1, -2)
    return X.to(G.dtype)


def is_muon_param(shape: tuple[int, ...]) -> bool:
    """Muon orthogonalises tensors of two or more dimensions, none of them
    a singleton, in the Flax layout; the rest take the momentum alone."""
    return len(shape) >= 2 and min(shape) > 1


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Muon(torch.optim.Optimizer):
    """``layouts`` maps each parameter to its pair of views (to the Flax
    layout, back from it); a parameter without an entry is taken as it is.
    ``strict`` raises at construction on matrix-like parameters outside the
    2-D / 4-D contract (rank 3 or 5+, or a singleton dimension), as the TPU
    package's OPTIMIZER.MUON.STRICT does."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.95,
                 nesterov: bool = True, ns_steps: int = 5, weight_decay: float = 0.0,
                 apply_scaling: bool = True, strict: bool = False,
                 layouts: Mapping[torch.Tensor, tuple[Callable, Callable]] | None = None):
        defaults = dict(lr=lr, momentum=momentum, nesterov=nesterov, ns_steps=ns_steps,
                        weight_decay=weight_decay, apply_scaling=apply_scaling)
        super().__init__(params, defaults)
        self.layouts = {id(p): v for p, v in (layouts or {}).items()}
        if strict:
            bad = [shape for group in self.param_groups for p in group["params"]
                   if len(shape := tuple(self._to_jax(p)(p).shape)) >= 2
                   and (len(shape) not in (2, 4) or min(shape) <= 1)]
            if bad:
                raise ValueError(
                    "Muon strict mode: matrix-like params must be 2D or 4D with no singleton "
                    "dims (rank-3/5+ would be flattened on an arbitrary split; singleton-dim "
                    f"matrices fall through to momentum-SGD); offending shapes: {bad[:5]}")

    def _to_jax(self, p):
        return self.layouts.get(id(p), (_identity, _identity))[0]

    def _orthogonal_update(self, p: torch.Tensor, d: torch.Tensor, group) -> torch.Tensor:
        to_jax, from_jax = self.layouts.get(id(p), (_identity, _identity))
        dj = to_jax(d)
        shape = tuple(dj.shape)
        d2 = dj.reshape(shape[0], -1) if dj.dim() > 2 else dj
        o = zeropower_via_newtonschulz5(d2, group["ns_steps"])
        if group["apply_scaling"]:
            o = o * max(1.0, d2.shape[-2] / d2.shape[-1]) ** 0.5
        return from_jax(o.reshape(shape))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            m = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = state["momentum_buffer"]
                buf.mul_(m).add_(g, alpha=1.0 - m)
                if is_muon_param(tuple(self._to_jax(p)(g).shape)):
                    d = g * (1.0 - m) + buf * m if group["nesterov"] else buf
                    update = self._orthogonal_update(p, d, group)
                else:
                    update = buf.clone()
                if group["weight_decay"] > 0:
                    update.add_(p, alpha=group["weight_decay"])
                p.add_(update, alpha=-group["lr"])
        return loss
