"""mFormerV1: hybrid ConvNeXt + 2D-RoPE transformer.

Port of linnaeus_tpu/models/mformer_v1.py, sequential towers only:

    4x4 conv stem -> ConvNeXt stage 1 -> downsample -> ConvNeXt stage 2
    -> downsample -> [CLS1 + meta tokens | patches] RoPE stage 3 -> LN
    -> strip extras, downsample -> [CLS2 + meta tokens | patches] RoPE stage 4
    -> LN -> dual-CLS Conv1d aggregation -> LN -> per-task heads

Submodule names follow the upstream state_dict layout (stem, stages,
downsample_layers, norm_1/2, cls_token_1/2, meta_*_head_*, cl_1_fc,
aggregate, final_norm, head), so a converted TPU checkpoint loads strict.
Images are NHWC, as in the TPU package. Parameters are float32; ``dtype``
is the compute dtype. MoE, ring attention and pipelining are not ported
yet and raise. ``gradient_checkpointing`` recomputes every ConvNeXt and
RoPE block of the towers in the backward, keeping what ``remat_policy``
names (models/utils.py); the flag may be flipped between calls, as the
GradNorm re-forward does. Dropout (``drop_rate`` in the RoPE blocks' MLP
and after their output projection, ``attn_drop_rate`` on the attention
output of the plain route) acts in training mode, as in the TPU package.
``forward(..., gradnorm_mode=True)`` returns the heads' base logits. The
heads get the taxonomy tree's
``hierarchy_matrices`` for HierarchicalSoftmax / ConditionalClassifier.
``attn_fp32_softmax`` False lets the plain attention path compute its scores
in the compute dtype (ops/attention.py); it has no effect on the K1 route.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from linnaeus_tpu_torch.models.blocks.common import (
    Conv1d,
    LayerNorm,
    MetaHead,
    Mlp,
    init_parameters,
    trunc_normal_,
)
from linnaeus_tpu_torch.models.blocks.convnext import (
    ConvNeXtBlock,
    ConvNeXtDownsampleLayer,
    ConvNeXtStem,
)
from linnaeus_tpu_torch.models.blocks.rope_mhsa import RoPE2DMHSABlock
from linnaeus_tpu_torch.models.heads.heads import MultiTaskHeads
from linnaeus_tpu_torch.models.utils import checkpoint_block, resolve_remat_policy


class MFormerV1(nn.Module):
    def __init__(
        self,
        img_size: tuple[int, int] = (384, 384),
        in_chans: int = 3,
        convnext_depths: tuple[int, ...] = (3, 3, 9, 3),
        convnext_dims: tuple[int, ...] = (96, 192, 384, 768),
        convnext_ls_init: float = 1e-6,
        rope_depths: tuple[int, int] = (5, 2),
        rope_dims: tuple[int, int] = (384, 768),
        rope_num_heads: tuple[int, int] = (8, 8),
        rope_mlp_ratio: tuple[float, float] = (4.0, 4.0),
        rope_theta: float = 10000.0,
        rope_mixed: bool = True,
        rope_fidelity: str = "rotate",
        act_exact: bool = False,
        fused_convnext_mlp: bool | None = None,
        use_flash_attn: bool = False,
        attn_fp32_softmax: bool = True,
        drop_path_rate: float = 0.1,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        only_last_cls: bool = False,
        aggregation: str = "Conv1d",
        meta_components: tuple[tuple[str, int], ...] = (),
        task_keys: tuple[str, ...] = (),
        num_classes: Mapping[str, int] | None = None,
        head_configs: Mapping[str, Mapping[str, Any]] | None = None,
        hierarchy_matrices: Mapping[str, np.ndarray] | None = None,
        moe_num_experts: int = 0,
        ring_attention: bool = False,
        pipeline_stages: int = 0,
        gradient_checkpointing: bool = False,
        remat_policy: str = "dots",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        for name, value in (
            ("moe_num_experts", moe_num_experts),
            ("ring_attention", ring_attention),
            ("pipeline_stages", pipeline_stages),
        ):
            if value:
                raise NotImplementedError(f"MFormerV1: {name} is not ported yet")
        if aggregation not in ("Conv1d", "default"):
            raise NotImplementedError(f"MFormerV1: aggregation {aggregation!r} is not ported yet")
        if tuple(rope_dims) != tuple(convnext_dims[2:4]):
            raise ValueError(
                f"RoPE dims {tuple(rope_dims)} must match ConvNeXt dims[2:4] "
                f"{tuple(convnext_dims[2:4])}"
            )
        if img_size[0] % 32 or img_size[1] % 32:
            raise ValueError(f"img_size {img_size} must be a multiple of 32")
        generator = torch.Generator().manual_seed(seed)
        self.gradient_checkpointing = bool(gradient_checkpointing)
        self.remat_policy = remat_policy
        if self.gradient_checkpointing:
            resolve_remat_policy(remat_policy)  # an unknown name raises here
        self.dtype = dtype
        self.only_last_cls = only_last_cls
        self.meta_components = tuple((str(n), int(d)) for n, d in meta_components)
        self.extra_token_num = 1 + len(self.meta_components)
        self.rope_dims = tuple(rope_dims)
        self.grid3 = (img_size[0] // 16, img_size[1] // 16)
        self.grid4 = (img_size[0] // 32, img_size[1] // 32)

        total_depth = sum(convnext_depths[:2]) + sum(rope_depths)
        dpr = iter(float(r) for r in np.linspace(0.0, drop_path_rate, total_depth))

        self.stem = ConvNeXtStem(in_chans, convnext_dims[0])
        conv_stages = [
            nn.ModuleList(
                ConvNeXtBlock(
                    convnext_dims[s], drop_path=next(dpr),
                    layer_scale_init_value=convnext_ls_init,
                    act_exact=act_exact, fused_mlp=fused_convnext_mlp,
                )
                for _ in range(convnext_depths[s])
            )
            for s in (0, 1)
        ]
        rope_stages = [
            nn.ModuleList(
                RoPE2DMHSABlock(
                    rope_dims[s], grid, extra_token_num=self.extra_token_num,
                    num_heads=rope_num_heads[s], mlp_ratio=rope_mlp_ratio[s],
                    rope_theta=rope_theta, rope_mixed=rope_mixed,
                    drop_path=next(dpr), use_flash_attn=use_flash_attn,
                    rope_fidelity=rope_fidelity, act_exact=act_exact,
                    attn_fp32_softmax=attn_fp32_softmax, drop=drop_rate,
                    attn_drop=attn_drop_rate, generator=generator,
                )
                for _ in range(rope_depths[s])
            )
            for s, grid in ((0, self.grid3), (1, self.grid4))
        ]
        self.stages = nn.ModuleList(conv_stages + rope_stages)
        self.downsample_layers = nn.ModuleList(
            ConvNeXtDownsampleLayer(convnext_dims[i], convnext_dims[i + 1])
            for i in range(3)
        )
        self.norm_1 = LayerNorm(rope_dims[0], eps=1e-5)
        self.norm_2 = LayerNorm(rope_dims[1], eps=1e-5)
        self.cls_token_1 = nn.Parameter(torch.zeros(1, 1, rope_dims[0]))
        self.cls_token_2 = nn.Parameter(torch.zeros(1, 1, rope_dims[1]))
        for s, width in ((1, rope_dims[0]), (2, rope_dims[1])):
            for name, dim in self.meta_components:
                if dim > 0:
                    setattr(self, f"meta_{name.lower()}_head_{s}", MetaHead(dim, width))
        if not only_last_cls:
            self.cl_1_fc = nn.Sequential(
                Mlp(rope_dims[0], rope_dims[0], rope_dims[1], act_exact=act_exact),
                LayerNorm(rope_dims[1], eps=1e-5),
            )
            # 2 -> 1 channel 1x1 conv over the two CLS tokens
            self.aggregate = Conv1d(2, 1, kernel_size=1)
        self.final_norm = LayerNorm(rope_dims[1], eps=1e-5)
        self.head = MultiTaskHeads(
            rope_dims[1], tuple(task_keys), num_classes or {}, head_configs, hierarchy_matrices)

        init_parameters(self, generator)
        with torch.no_grad():
            trunc_normal_(self.cls_token_1, generator)
            trunc_normal_(self.cls_token_2, generator)

    def _block(self, blk: nn.Module, x: torch.Tensor, *args) -> torch.Tensor:
        """One tower block, checkpointed when gradient checkpointing is on
        and a gradient is being recorded."""
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint_block(blk, x, *args,
                                    context_fn=resolve_remat_policy(self.remat_policy))
        return blk(x, *args)

    def _extras(self, stage: int, meta: torch.Tensor, B: int) -> torch.Tensor:
        """CLS then one token per metadata component, (B, 1 + n_meta, C)."""
        cls = self.cls_token_1 if stage == 1 else self.cls_token_2
        tokens = [cls.to(self.dtype).expand(B, -1, -1)]
        start = 0
        for name, dim in self.meta_components:
            if dim > 0:
                head = getattr(self, f"meta_{name.lower()}_head_{stage}")
                tokens.append(head(meta[:, start:start + dim].to(self.dtype))[:, None, :])
            start += dim
        return torch.cat(tokens, dim=1)

    def forward_features(
        self, x: torch.Tensor, meta: torch.Tensor | None = None
    ) -> torch.Tensor:
        B = x.shape[0]
        if meta is None and self.meta_components:
            # absent metadata is the fully masked (all-zero) aux vector
            total = sum(d for _, d in self.meta_components)
            meta = torch.zeros((B, total), dtype=self.dtype, device=x.device)
        # the ConvNeXt blocks' route (K2's training route or not) is fixed
        # here and passed in, so a recomputed block takes it again
        training = torch.is_grad_enabled()
        x = self.stem(x.to(self.dtype))  # (B, H/4, W/4, D0)
        for blk in self.stages[0]:
            x = self._block(blk, x, training)
        x = self.downsample_layers[0](x)  # (B, H/8, W/8, D1)
        for blk in self.stages[1]:
            x = self._block(blk, x, training)
        x = self.downsample_layers[1](x)  # (B, H/16, W/16, D2)

        h3, w3 = self.grid3
        x = x.reshape(B, h3 * w3, self.rope_dims[0])
        x = torch.cat([self._extras(1, meta, B), x], dim=1)
        for blk in self.stages[2]:
            x = self._block(blk, x)
        x = self.norm_1(x)
        if not self.only_last_cls:
            cls_1 = self.cl_1_fc(x[:, 0:1, :])

        x = x[:, self.extra_token_num:, :].reshape(B, h3, w3, self.rope_dims[0])
        x = self.downsample_layers[2](x)  # (B, H/32, W/32, D3)
        h4, w4 = self.grid4
        x = x.reshape(B, h4 * w4, self.rope_dims[1])
        x = torch.cat([self._extras(2, meta, B), x], dim=1)
        for blk in self.stages[3]:
            x = self._block(blk, x)
        x = self.norm_2(x)
        cls_2 = x[:, 0:1, :]
        if self.only_last_cls:
            return self.final_norm(cls_2[:, 0, :])
        agg = self.aggregate(torch.cat([cls_1, cls_2], dim=1))[:, 0, :]  # (B, D3)
        return self.final_norm(agg)

    def forward(
        self, x: torch.Tensor, meta: torch.Tensor | None = None, gradnorm_mode: bool = False,
    ) -> dict[str, torch.Tensor]:
        """NHWC images (and the packed aux vector) -> float32 logits by task;
        ``gradnorm_mode`` skips the hierarchical refinement (the GradNorm
        re-forward's linear heads)."""
        return self.head(self.forward_features(x, meta), gradnorm_mode=gradnorm_mode)
