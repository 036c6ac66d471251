"""Mixture-of-Experts MLP (V-MoE style).

Port of linnaeus_tpu/models/blocks/moe.py. A bank of E expert MLPs replaces
the dense transformer MLP on selected RoPE blocks, and each token goes to
its top-k experts. The parameters keep the TPU package's layout and names
(``router`` (D, E), ``wi`` (E, D, F), ``bi`` (E, F), ``wo`` (E, F, D),
``bo`` (E, D)), so the weight bridge (utils/convert.py) is an identity for
them and the parameter filters and Muon see the tensors the TPU package
sees.

The routing is the TPU package's: the router runs in float32, the experts in
the compute dtype; top-k takes the lower expert index first on ties (a
stable descending sort: ``torch.topk`` promises no order on ties, where
``jax.lax.top_k`` does); the k gates are renormalised with a 1e-9 floor;
within each image all rank-0 choices fill expert slots in token order
before any rank-1 choice, and a choice past the C = ceil(k N f / E) slots of
its expert is dropped (its output is zero, so the block's residual passes
the token through).

The dispatch differs in form only. Where the TPU package builds one-hot
(B, N, E, C) dispatch and combine tensors and contracts them on the MXU,
this module writes each kept (token, choice) into an (E, B C, D) slot buffer
by its flat slot index (one extra row takes the dropped choices and is
discarded), runs the experts as two batched products and gathers each
token's k outputs back, weighted by its gates in an elementwise sum. At
mFormerV1_sm_moe's stage 3 (B 64, N 580, E 8, C 182) each one-hot tensor
would hold 216 MB in float32.

``forward`` returns the output and the layer's statistics (float32
scalars): the Switch load-balance loss E * sum_e f_e P_e (f from the top-1
choice before capacity, P the mean router probability; 1.0 at uniform
routing), the router z-loss mean(logsumexp(logits)^2) and the share of
dropped choices. They leave the model through its forward's return value
(models/mformer_v1.py), never through module state, so a checkpointed
block's recompute adds no second copy. Router noise (``noise_std`` > 0, in
units of 1/E, training mode only) draws from ``generator``, which
``create_train_state`` sets to the step's generator.

Tracing (utils/tracing.py, off by default): ``forward`` is the
``MoEMlp.forward`` span, which ``tools/profile_step.py`` reads, and holds
four: ``/route`` (the router product, softmax, sort, queue positions and
the statistics), ``/dispatch`` (the slot buffer's ``index_put``),
``/experts`` (the two batched products and the GELU) and ``/combine``.
While tracing is on, each call also counts, per expert, the choices routed
to it before capacity, the kept ones and the dropped ones (a (3, E) int64
tensor, ``count``ed under ``MoEMlp.counts/<trace_name>``, never read
inside the step); off, it launches no work for them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from linnaeus_tpu_torch.utils import tracing
from linnaeus_tpu_torch.utils.tracing import span

from .common import Dropout, draw_rows, gelu, trunc_normal_


class MoEStats(NamedTuple):
    """One MoE layer's statistics, float32 scalars."""

    aux: torch.Tensor
    z: torch.Tensor
    drop_frac: torch.Tensor


def capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert per image: ceil(k N f / E), at least 1."""
    k = min(int(top_k), int(num_experts))
    return max(1, int(math.ceil(k * num_tokens * capacity_factor / num_experts)))


def route(logits: torch.Tensor, top_k: int, cap: int):
    """The routing of float32 router ``logits`` (B, N, E): (probs, gates
    (B, N, K) renormalised, experts (B, N, K), slots (B, N, K) the position
    of each choice in its expert's queue for this image, keep (B, N, K))."""
    B, N, E = logits.shape
    K = min(int(top_k), E)
    probs = torch.softmax(logits, dim=-1)
    # a stable sort keeps the lower expert index first among equal probabilities
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :K], experts[..., :K]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # rank-major order: (B, K * N) choices, all rank-0 choices first
    chosen = experts.transpose(1, 2).reshape(B, K * N)
    onehot = F.one_hot(chosen, E)
    position = onehot.cumsum(dim=1).gather(2, chosen[..., None])[..., 0] - 1
    slots = position.view(B, K, N).transpose(1, 2)
    return probs, gates, experts, slots, slots < cap


class MoEMlp(nn.Module):
    """Drop-in replacement for ``Mlp`` on (B, N, D) tokens; ``forward``
    returns ``(y, MoEStats)``. ``hidden_features`` is each expert's hidden
    width; ``drop`` acts after the activation and after the output, as in
    ``Mlp``. The weights are drawn from ``generator`` (trunc-normal router
    and expert kernels, zero biases), as the TPU package initialises them."""

    def __init__(self, dim: int, hidden_features: int, num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25, noise_std: float = 0.0, drop: float = 0.0,
                 act_exact: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        E, F_ = int(num_experts), int(hidden_features)
        self.num_experts, self.top_k = E, min(int(top_k), E)
        self.capacity_factor = float(capacity_factor)
        self.noise_std = float(noise_std)
        self.act_exact = act_exact
        self.router = nn.Parameter(torch.empty(dim, E))
        self.wi = nn.Parameter(torch.empty(E, dim, F_))
        self.bi = nn.Parameter(torch.zeros(E, F_))
        self.wo = nn.Parameter(torch.empty(E, F_, dim))
        self.bo = nn.Parameter(torch.zeros(E, dim))
        self.drop1 = Dropout(drop)
        self.drop2 = Dropout(drop)
        # the slot buffer's rows of one rank are contiguous along its axis 1
        self.drop1.batch_dim = self.drop2.batch_dim = 1
        self.generator: torch.Generator | None = None  # the router noise's
        self.trace_name = "MoEMlp"  # its counters' name; the model names its layers
        # parallel/: the data group (global statistics and draws) and the
        # model group the expert banks split over (expert parallelism)
        self.data_group = None
        self.expert_group = None
        init = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in (self.router, self.wi, self.wo):
                trunc_normal_(p, init)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, MoEStats]:
        with span("MoEMlp.forward"):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> tuple[torch.Tensor, MoEStats]:
        B, N, D = x.shape
        E, K, dt = self.num_experts, self.top_k, x.dtype
        C = capacity(N, E, K, self.capacity_factor)
        with span("MoEMlp.forward/route"):
            logits = x.float() @ self.router.float()  # (B, N, E)
            if self.noise_std > 0.0 and self.training:
                noise = draw_rows(torch.randn, logits.shape, logits.device, self.generator,
                                  self.data_group)
                logits = logits + noise * (self.noise_std / E)
            probs, gates, experts, slots, keep = route(logits, K, C)
            stats = self._stats(logits, probs, experts, keep)
            if tracing.on():
                routed = experts[..., None] == torch.arange(E, device=x.device)
                counts = torch.stack([routed.sum(dim=(0, 1, 2)),
                                      (routed & keep[..., None]).sum(dim=(0, 1, 2))])
                tracing.count(f"MoEMlp.counts/{self.trace_name}",
                              torch.cat([counts, counts[:1] - counts[1:]]))

        with span("MoEMlp.forward/dispatch"):
            # choice (b, n, k) -> row experts * B C + b C + slot; every
            # dropped choice -> the extra last row
            rows = experts * (B * C) + torch.arange(B, device=x.device)[:, None, None] * C + slots
            rows = torch.where(keep, rows, torch.full_like(rows, E * B * C)).reshape(-1)
            tokens = x[:, :, None, :].expand(B, N, K, D).reshape(B * N * K, D)
            buf = x.new_zeros(E * B * C + 1, D).index_put((rows,), tokens)
            xe = buf[:-1].view(E, B * C, D)

        with span("MoEMlp.forward/experts"):
            ye = self._experts(xe) if self.expert_group is None else self._expert_parallel(xe)

        with span("MoEMlp.forward/combine"):
            # each token's k outputs weighted by its gates (in the compute
            # dtype, as the TPU package casts them), zero where dropped, summed
            # in float32 and rounded once; an elementwise sum, since a batched
            # product of B N (1, K) x (K, D) matrices is a pathological GEMM
            picked = ye.reshape(E * B * C, D).index_select(0, rows.clamp_max(E * B * C - 1))
            weights = torch.where(keep, gates, torch.zeros_like(gates)).to(dt)
            y = (weights.float()[..., None] * picked.view(B, N, K, D).float()).sum(dim=2).to(dt)
        return y, stats

    def _stats(self, logits, probs, experts, keep) -> MoEStats:
        """The layer's auxiliary statistics, float32."""
        B, N, E = logits.shape
        K = experts.shape[-1]
        if self.data_group is None:
            f = F.one_hot(experts[..., 0], E).float().mean(dim=(0, 1))
            aux = E * (f * probs.mean(dim=(0, 1))).sum()
            z = torch.logsumexp(logits, dim=-1).square().mean()
            drop_frac = 1.0 - keep.sum().float() / float(B * N * K)
            return MoEStats(aux, z, drop_frac)
        # the global batch's: this rank's sums gathered from every rank and
        # added in rank order (the loss that reads them is the same on every
        # rank, so each rank's sums take their slice of its gradient)
        from linnaeus_tpu_torch.parallel.ops import gather_rows, group_size

        sums = torch.cat([F.one_hot(experts[..., 0], E).float().sum(dim=(0, 1)),
                          probs.sum(dim=(0, 1)),
                          torch.logsumexp(logits, dim=-1).square().sum()[None],
                          keep.sum().float()[None]])
        sums = gather_rows(sums[None], self.data_group).sum(dim=0)
        count = float(B * N * group_size(self.data_group))
        aux = E * ((sums[:E] / count) * (sums[E:2 * E] / count)).sum()
        return MoEStats(aux, sums[2 * E] / count, 1.0 - sums[2 * E + 1] / (count * K))

    def _experts(self, xe: torch.Tensor) -> torch.Tensor:
        """The banks this module holds on their (e, S, D) slot rows, as
        batched products in the compute dtype."""
        dt = xe.dtype
        h = torch.baddbmm(self.bi.to(dt)[:, None, :], xe, self.wi.to(dt))
        h = self.drop1(gelu(h, self.act_exact))
        return self.drop2(torch.baddbmm(self.bo.to(dt)[:, None, :], h, self.wo.to(dt)))

    def _expert_parallel(self, xe: torch.Tensor) -> torch.Tensor:
        """Expert parallelism over ``expert_group`` (P ranks, E / P experts
        each, the ranks' tokens the same): rank m keeps the m-th block of
        the (E, S, D) buffer's slots, sends each expert's rows of it to the
        rank that owns that expert and receives its own experts' rows of
        every rank's block (``all_to_all_single``, differentiable), runs its
        experts (the banks hold this rank's E / P of them, parallel/model.py)
        on all S slots, and the outputs go back the same way and are
        gathered over the slot blocks."""
        from torch.distributed.nn.functional import all_to_all_single

        from linnaeus_tpu_torch.parallel.ops import gather_rows, group_size, split_rows

        group = self.expert_group
        P = group_size(group)
        E, S, D = xe.shape
        if E % P or S % P:
            raise ValueError(f"expert parallelism: {E} experts and {S} slots must divide over "
                             f"the {P}-way model axis")
        if self.drop1.rate > 0 or self.drop2.rate > 0:
            raise ValueError("expert parallelism with MLP dropout: the expert buffers' masks "
                             "are not drawn as the one-process run draws them")
        el = E // P
        block = split_rows(xe, group, dim=1)  # (E, S / P, D): expert-major
        mine = all_to_all_single(torch.empty_like(block), block.contiguous(), group=group)
        # (P, el, S / P, D) from ranks 0 .. P-1 -> (el, S, D) in slot order
        mine = mine.view(P, el, S // P, D).transpose(0, 1).reshape(el, S, D)
        ye = self._experts(mine)
        back = ye.view(el, P, S // P, D).transpose(0, 1).contiguous().view(E, S // P, D)
        ye = all_to_all_single(torch.empty_like(back), back, group=group)
        return gather_rows(ye, group, dim=1)
