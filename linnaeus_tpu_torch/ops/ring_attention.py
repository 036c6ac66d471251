"""Ring attention: exact attention with the token axis split over a group.

Port of linnaeus_tpu/ops/ring_attention.py. Each rank keeps its block of
queries while the key/value blocks travel around the ring of the group
(rank r sends to r + 1 and receives from r - 1 with ``batch_isend_irecv``),
one hop per step, P steps on a P-rank group, and the softmax is accumulated
with the online (running max and denominator) recurrence in float32: the
TPU package's math, step for step, with plain ``torch`` products where the
TPU package's are einsums outside Pallas.

Point-to-point operations are not differentiable, so the ring is a
``torch.autograd.Function``: its backward runs the reverse ring, sending the
key/value blocks round the other way (rank r to r - 1) with their dK and dV
sums, recomputes each block's probabilities from the saved log-sum-exp and
adds the block's share to dQ here and to the travelling dK and dV; after P
hops every block is home with its whole gradient.

Layout: q, k and v are (B, H, N, D). :func:`ring_attention` takes the
whole (replicated) arrays, as the TPU package's global view does, keeps this
rank's contiguous token block, and gathers the blocks of the output back;
N must divide by the group's size (``ValueError`` else); ``n_valid`` < N
masks trailing padded key columns out of the softmax exactly, and padded
query rows give garbage that the caller slices away.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from linnaeus_tpu_torch.parallel.ops import gather_rows, group_rank, group_size, split_rows

NEG_INF = -1e30


def _ring_pass(t: torch.Tensor, group, hop: int = 1) -> torch.Tensor:
    """``t`` sent ``hop`` ranks on round the ring (1: to the next, -1: to
    the previous), the tensor coming from the other side received."""
    n, r = group_size(group), group_rank(group)
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, (r + hop) % n),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - hop) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _valid_columns(n_loc, src, n_valid, device):
    """(n_loc,) bool: the key columns of the block from ring position ``src``
    below ``n_valid``."""
    return torch.arange(n_loc, device=device) + src * n_loc < n_valid


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, n_valid, n_global):
        p_size, me = group_size(group), group_rank(group)
        B, H, n_loc, D = q.shape
        qs = q.float() * scale
        mask = n_valid < n_global
        m = torch.full((B, H, n_loc, 1), float("-inf"), device=q.device)
        l = torch.zeros((B, H, n_loc, 1), device=q.device)
        acc = torch.zeros((B, H, n_loc, D), device=q.device)
        kv = torch.stack([k, v])
        for step in range(p_size):
            kc, vc = kv[0].float(), kv[1].float()
            s = qs @ kc.transpose(-1, -2)
            if mask:
                valid = _valid_columns(n_loc, (me - step) % p_size, n_valid, q.device)
                s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            if mask:
                # a fully masked block would otherwise add exp(0) = 1 of mass
                p = torch.where(valid, p, torch.zeros_like(p))
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vc
            m = m_new
            if step + 1 < p_size:
                kv = _ring_pass(kv, group)
        l = l.clamp_min(1e-30)
        out = (acc / l).to(v.dtype)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale, ctx.n_valid, ctx.n_global = group, scale, n_valid, n_global
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        p_size, me = group_size(group), group_rank(group)
        n_loc = q.shape[2]
        mask = ctx.n_valid < ctx.n_global
        qf, do = q.float(), dout.float()
        qs = qf * scale
        delta = (do * out.float()).sum(-1, keepdim=True)
        dq = torch.zeros_like(qf)
        # the travelling block: k, v and their gradient sums
        block = torch.stack([k.float(), v.float(), torch.zeros_like(qf), torch.zeros_like(qf)])
        for step in range(p_size):
            kc, vc = block[0], block[1]
            s = qs @ kc.transpose(-1, -2)
            p = torch.exp(s - lse)
            if mask:  # the reverse ring: this block comes from ring position me + step
                valid = _valid_columns(n_loc, (me + step) % p_size, ctx.n_valid, q.device)
                p = torch.where(valid, p, torch.zeros_like(p))
            dv = p.transpose(-1, -2) @ do
            ds = p * (do @ vc.transpose(-1, -2) - delta)
            dq = dq + ds @ kc * scale
            dk = ds.transpose(-1, -2) @ qs
            block = torch.stack([kc, vc, block[2] + dk, block[3] + dv])
            if p_size > 1:
                block = _ring_pass(block, group, hop=-1)  # after P hops every block is home
        return (dq.to(q.dtype), block[2].to(k.dtype), block[3].to(v.dtype),
                None, None, None, None)


def ring_attention_shard(q, k, v, group, scale: float, n_valid: int, n_global: int):
    """The ring over this rank's token blocks (B, H, N / P, D)."""
    return _Ring.apply(q, k, v, group, float(scale), int(n_valid), int(n_global))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   scale: float | None = None, n_valid: int | None = None) -> torch.Tensor:
    """Exact softmax attention with the token axis (2) split over ``group``
    (None: this process alone, a ring of one). q, k, v: the whole (B, H, N,
    D) arrays, the same on every rank of the group; N must divide by its
    size; ``n_valid`` (< N) marks trailing padding excluded from the
    softmax. Returns the whole output, the same on every rank."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, p_size = q.shape[2], group_size(group)
    if n % p_size:
        raise ValueError(
            f"ring_attention: N={n} not divisible by mesh axis 'model' of size {p_size}")
    if n_valid is None or n_valid > n:
        n_valid = n
    blocks = [split_rows(t, group, dim=2) for t in (q, k, v)]
    out = ring_attention_shard(*blocks, group, scale, n_valid, n)
    return gather_rows(out, group, dim=2)
