"""mFormerV0: the MetaFormer (MetaFG) hybrid of convolutions and relative
attention.

Port of linnaeus_tpu/models/mformer_v0.py (reference: models/mFormerV0.py:66-660):

    3-conv stem (+BN/ReLU, maxpool; /4) -> MBConv stage 1 -> MBConv stage 2
    (/8) -> RelativeAttention stage 3 (OverlapPatchEmbed /16, CLS1 + meta
    tokens) -> LN -> RelativeAttention stage 4 (/32, CLS2 + meta tokens)
    -> LN -> dual-CLS Conv1d aggregation -> LN -> per-task heads

``stage_dims`` are (stem, MBConv 1, MBConv 2, attention 3, attention 4)
output widths; the first block of each attention stage strides 2 and
re-embeds. Module names follow MetaFG's ``state_dict`` (``stage_0.{0,3,6}``
convolutions and ``stage_0.{1,4}`` BatchNorms of the stem, ``bn1``,
``stage_{1,2}.{j}._expand_conv`` ..., ``stage_{3,4}.{j}.attn.qkv`` ...,
``norm_1``/``norm_2``, ``cls_token_{1,2}``, ``meta_*_head_*``, ``cl_1_fc``,
``aggregate``, ``norm``, ``head``), so a MetaFormer checkpoint maps one key to
one key (utils/pretrained.py). The BatchNorms are Flax's (blocks/common.py):
eps 1e-5 in the stem, 0.01 in the MBConvs, running statistics as buffers.
Images are NHWC; parameters float32; ``dtype`` is the compute dtype.

``drop_rate`` is the MBConvs' drop-connect and the attention blocks' MLP and
projection dropout; ``attn_drop_rate`` falls on the attention probabilities;
``drop_path_rate`` grows as ``rate * i / (number of attention blocks)`` over
the attention blocks, as in the JAX package. ``gradient_checkpointing`` and
``use_flash_attn`` are accepted and unused, as there: relative attention has
no flash variant, and a BatchNorm inside a recomputed region would update its
running statistics twice.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from linnaeus_tpu_torch.models.blocks.common import (
    BatchNorm,
    Conv1d,
    Conv2d,
    LayerNorm,
    MetaHead,
    Mlp,
    conv_nhwc,
    init_parameters,
    trunc_normal_,
)
from linnaeus_tpu_torch.models.blocks.mbconv import MBConvBlock
from linnaeus_tpu_torch.models.blocks.relative_mhsa import RelativeMHSABlock
from linnaeus_tpu_torch.models.factory import register_model
from linnaeus_tpu_torch.models.heads.heads import MultiTaskHeads


@register_model("mFormerV0")
class MFormerV0(nn.Module):
    def __init__(
        self,
        img_size: tuple[int, int] = (384, 384),
        in_chans: int = 3,
        stage_dims: tuple[int, ...] = (64, 96, 192, 384, 768),
        mbconv_depths: tuple[int, int] = (2, 3),
        attn_depths: tuple[int, int] = (5, 2),
        num_heads: tuple[int, int] = (6, 12),
        mlp_ratio: tuple[float, float] = (4.0, 4.0),
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.1,
        only_last_cls: bool = False,
        meta_components: tuple[tuple[str, int], ...] = (),
        task_keys: tuple[str, ...] = (),
        num_classes: Mapping[str, int] | None = None,
        head_configs: Mapping[str, Mapping[str, Any]] | None = None,
        hierarchy_matrices: Mapping[str, np.ndarray] | None = None,
        gradient_checkpointing: bool = False,
        act_exact: bool = False,
        use_flash_attn: bool = False,
        attn_fp32_softmax: bool = True,
        head_split: bool = False,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        if img_size[0] % 32 or img_size[1] % 32:
            raise ValueError(f"img_size {img_size} must be a multiple of 32")
        generator = torch.Generator().manual_seed(seed)
        self.gradient_checkpointing = bool(gradient_checkpointing)
        self.dtype = dtype
        self.only_last_cls = only_last_cls
        self.stage_dims = dims = tuple(stage_dims)
        self.mbconv_depths, self.attn_depths = tuple(mbconv_depths), tuple(attn_depths)
        self.meta_components = tuple((str(n), int(d)) for n, d in meta_components)
        self.extra_token_num = 1 + len(self.meta_components)
        self.task_keys = tuple(task_keys)
        grid2 = (img_size[0] // 8, img_size[1] // 8)
        self.grid3 = (grid2[0] // 2, grid2[1] // 2)
        grid4 = (self.grid3[0] // 2, self.grid3[1] // 2)

        stem0 = 3 * (dims[0] // 4)
        self.stage_0 = nn.Sequential(
            Conv2d(in_chans, stem0, 3, stride=2, padding=1, bias=False),
            BatchNorm(stem0, eps=1e-5), nn.ReLU(),
            Conv2d(stem0, dims[0], 3, padding=1, bias=False),
            BatchNorm(dims[0], eps=1e-5), nn.ReLU(),
            Conv2d(dims[0], dims[0], 3, padding=1, bias=False),
        )
        self.bn1 = BatchNorm(dims[0], eps=1e-5)
        self.stage_1 = nn.ModuleList(
            MBConvBlock(dims[0] if i == 0 else dims[1], dims[1], expand_ratio=4, stride=1,
                        drop_connect_rate=drop_rate)
            for i in range(self.mbconv_depths[0]))
        self.stage_2 = nn.ModuleList(
            MBConvBlock(dims[1] if i == 0 else dims[2], dims[2], expand_ratio=4,
                        stride=2 if i == 0 else 1, drop_connect_rate=drop_rate)
            for i in range(self.mbconv_depths[1]))

        total_attn = max(sum(self.attn_depths), 1)

        def attn_stage(s: int, in_dim: int, dim: int, grid_in, grid, first: int):
            return nn.ModuleList(
                RelativeMHSABlock(
                    in_dim if i == 0 else dim, dim, grid_in if i == 0 else grid,
                    stride=2 if i == 0 else 1, num_heads=num_heads[s],
                    mlp_ratio=mlp_ratio[s], drop_path=drop_path_rate * (first + i) / total_attn,
                    extra_token_num=self.extra_token_num, qkv_bias=True,
                    attn_drop=attn_drop_rate, proj_drop=drop_rate, act_exact=act_exact,
                    attn_fp32_softmax=attn_fp32_softmax, head_split=head_split)
                for i in range(self.attn_depths[s]))

        self.stage_3 = attn_stage(0, dims[2], dims[3], grid2, self.grid3, 0)
        self.stage_4 = attn_stage(1, dims[3], dims[4], self.grid3, grid4, self.attn_depths[0])
        self.norm_1 = LayerNorm(dims[3], eps=1e-5)
        self.norm_2 = LayerNorm(dims[4], eps=1e-5)
        self.cls_token_1 = nn.Parameter(torch.zeros(1, 1, dims[3]))
        self.cls_token_2 = nn.Parameter(torch.zeros(1, 1, dims[4]))
        for s, width in ((1, dims[3]), (2, dims[4])):
            for name, dim in self.meta_components:
                setattr(self, f"meta_{name.lower()}_head_{s}", MetaHead(dim, width))
        if not only_last_cls:
            self.cl_1_fc = nn.Sequential(
                Mlp(dims[3], dims[3], dims[4], act_exact=act_exact),
                LayerNorm(dims[4], eps=1e-5),
            )
            self.aggregate = Conv1d(2, 1, kernel_size=1)
        self.norm = LayerNorm(dims[4], eps=1e-5)
        self.head = MultiTaskHeads(
            dims[4], self.task_keys, num_classes or {}, head_configs, hierarchy_matrices)

        init_parameters(self, generator)
        with torch.no_grad():
            for s in (self.cls_token_1, self.cls_token_2):
                trunc_normal_(s, generator)
            for blk in (*self.stage_3, *self.stage_4):
                trunc_normal_(blk.attn.relative_position_bias_table, generator)

    def _extras(self, stage: int, meta: torch.Tensor | None, B: int) -> torch.Tensor:
        """CLS then one token per metadata component, (B, 1 + n_meta, C)."""
        cls = self.cls_token_1 if stage == 1 else self.cls_token_2
        tokens = [cls.to(self.dtype).expand(B, -1, -1)]
        if meta is not None:
            start = 0
            for name, dim in self.meta_components:
                head = getattr(self, f"meta_{name.lower()}_head_{stage}")
                tokens.append(head(meta[:, start:start + dim].to(self.dtype))[:, None, :])
                start += dim
        return torch.cat(tokens, dim=1)

    def forward_features(self, x: torch.Tensor, meta: torch.Tensor | None = None
                         ) -> torch.Tensor:
        B = x.shape[0]
        if meta is None and self.meta_components:
            # absent metadata is the fully masked (all-zero) aux vector
            total = sum(d for _, d in self.meta_components)
            meta = torch.zeros((B, total), dtype=self.dtype, device=x.device)
        x = x.to(self.dtype)
        for layer in self.stage_0:
            x = conv_nhwc(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
        x = F.relu(self.bn1(x))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for blk in (*self.stage_1, *self.stage_2):
            x = blk(x)

        y = x
        for i, blk in enumerate(self.stage_3):
            y = blk(y, self._extras(1, meta, B) if i == 0 else None)
        y = self.norm_1(y)
        if not self.only_last_cls:
            cls_1 = self.cl_1_fc(y[:, 0:1, :])

        h3, w3 = self.grid3
        y = y[:, self.extra_token_num:, :].reshape(B, h3, w3, self.stage_dims[3])
        for i, blk in enumerate(self.stage_4):
            y = blk(y, self._extras(2, meta, B) if i == 0 else None)
        y = self.norm_2(y)
        cls_2 = y[:, 0:1, :]
        if self.only_last_cls:
            return self.norm(cls_2[:, 0, :])
        agg = self.aggregate(torch.cat([cls_1, cls_2], dim=1))[:, 0, :]  # (B, D4)
        return self.norm(agg)

    def forward(self, x: torch.Tensor, meta: torch.Tensor | None = None,
                gradnorm_mode: bool = False) -> dict[str, torch.Tensor]:
        """NHWC images (and the packed aux vector) -> float32 logits by task;
        ``gradnorm_mode`` skips the hierarchical refinement."""
        return self.head(self.forward_features(x, meta), gradnorm_mode=gradnorm_mode)

    @property
    def parameter_groups_metadata(self) -> dict[str, Any]:
        """In Flax path terms, as the JAX package's (param filters read Flax paths)."""
        return {
            "stages": {
                "conv_stages": ["stem_", "bn1", "stage1_", "stage2_"],
                "attn_stages": ["stage3_", "stage4_"],
            },
            "heads": {
                "classification_heads": ["head"],
                "meta_heads": ["meta_"],
            },
            "embeddings": ["cls_token"],
            "norm_layers": ["norm", "bn"],
            "aggregation": ["cl_1_fc", "aggregate", "final_norm"],
        }

    @property
    def pretrained_ckpt_handling_metadata(self) -> dict[str, Any]:
        return {
            "drop_buffers": ["relative_position_index"],
            "drop_params": ["head", "meta_"],
            "interpolate_rel_pos_bias": True,
            "supports_module_prefix": True,
            "strict": False,
        }
