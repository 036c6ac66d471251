"""mFormerV1 as plain float32 PyTorch functions.

The benchmark's reference of the model it measures, written from the
architecture's description and independent of the program: it imports no
module of the program and builds no ``nn.Module``. Weights are a dict of
tensors under the names of the published state_dict layout, which is how
the benchmark hands one set of weights to both sides. Activations are NHWC.

    4x4 conv stem + LN -> ConvNeXt stage 1 -> LN + 2x2 conv -> ConvNeXt stage 2
    -> LN + 2x2 conv -> [CLS1 | a token per metadata component | patches]
    2D-RoPE stage 3 -> LN -> CLS1 through an MLP + LN; patches -> LN + 2x2
    conv -> [CLS2 | metadata tokens | patches] 2D-RoPE stage 4 -> LN -> the
    two CLS tokens mixed by a 1x1 Conv1d -> LN -> a linear head per task

ConvNeXt block: 7x7 depthwise conv, LN (eps 1e-6), Linear 4C, GELU (tanh
form), Linear C, layer scale, drop-path residual. RoPE block: pre-LN (eps
1e-5) attention with 2D rotary embeddings on the patch tokens (learned
mixed frequencies, interleaved feature pairs; CLS and metadata tokens
unrotated), scale head_dim ** -0.5, then a pre-LN MLP; each with a
drop-path residual. A configuration with a mixture of experts is refused:
the reference has no expert bank.

``quant`` (the control of the correctness check) rounds both operands of
every product and convolution to float8 e4m3 with a per-tensor scale in the
forward pass; the gradient passes the rounding unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def spec_from_config(cfg: dict, num_classes: dict) -> dict:
    """The reference's geometry from a configuration file's ``config``
    section (every key it reads is stated there)."""
    m, d = cfg["MODEL"], cfg["DATA"]
    if m.get("MOE", {}).get("ENABLED", False):
        raise NotImplementedError("the reference has no mixture of experts")
    cs, rs = m["CONVNEXT_STAGES"], m["ROPE_STAGES"]
    comps = sorted(((c["IDX"], name, int(c["DIM"]))
                    for name, c in d["META"]["COMPONENTS"].items() if c["ENABLED"]))
    return {
        "img": int(m["IMG_SIZE"]),
        "cdepths": [int(v) for v in cs["DEPTHS"][:2]],
        "cdims": [int(v) for v in cs["DIMS"]],
        "rdepths": [int(v) for v in rs["DEPTHS"]],
        "rdims": [int(v) for v in rs["DIMS"]],
        "heads": [int(v) for v in rs["NUM_HEADS"]],
        "mlp_ratio": [float(v) for v in rs["MLP_RATIO"]],
        "theta": float(rs["ROPE_THETA"]),
        "meta": [(name, dim) for _, name, dim in comps],
        "tasks": [(t, int(num_classes[t])) for t in d["TASK_KEYS_H5"]],
        "drop_path_rate": float(m["DROP_PATH_RATE"]),
    }


def param_shapes(spec: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter by its state_dict name, in the layout's order."""
    c, r = spec["cdims"], spec["rdims"]
    out: dict[str, tuple[int, ...]] = {"cls_token_1": (1, 1, r[0]), "cls_token_2": (1, 1, r[1])}

    def lin(name, i, o, bias=True):
        out[f"{name}.weight"] = (o, i)
        if bias:
            out[f"{name}.bias"] = (o,)

    def ln(name, dim):
        out[f"{name}.weight"], out[f"{name}.bias"] = (dim,), (dim,)

    out["stem.0.weight"], out["stem.0.bias"] = (c[0], 3, 4, 4), (c[0],)
    ln("stem.1", c[0])
    for s in (0, 1):
        for j in range(spec["cdepths"][s]):
            p, C = f"stages.{s}.{j}", c[s]
            out[f"{p}.gamma"] = (C,)
            out[f"{p}.dwconv.weight"], out[f"{p}.dwconv.bias"] = (C, 1, 7, 7), (C,)
            ln(f"{p}.norm", C)
            lin(f"{p}.pwconv1", C, 4 * C)
            lin(f"{p}.pwconv2", 4 * C, C)
    for s in (0, 1):
        D, H = r[s], spec["heads"][s]
        hidden = int(D * spec["mlp_ratio"][s])
        for j in range(spec["rdepths"][s]):
            p = f"stages.{s + 2}.{j}"
            ln(f"{p}.norm1", D)
            out[f"{p}.attn.freqs"] = (2, H, D // H // 2)
            lin(f"{p}.attn.qkv", D, 3 * D)
            lin(f"{p}.attn.proj", D, D)
            ln(f"{p}.norm2", D)
            lin(f"{p}.mlp.fc1", D, hidden)
            lin(f"{p}.mlp.fc2", hidden, D)
    for i in range(3):
        ln(f"downsample_layers.{i}.norm", c[i])
        out[f"downsample_layers.{i}.conv.weight"] = (c[i + 1], c[i], 2, 2)
        out[f"downsample_layers.{i}.conv.bias"] = (c[i + 1],)
    ln("norm_1", r[0])
    ln("norm_2", r[1])
    for s, width in ((1, r[0]), (2, r[1])):
        for name, dim in spec["meta"]:
            p = f"meta_{name.lower()}_head_{s}"
            lin(f"{p}.0", dim, width)
            ln(f"{p}.2", width)
            lin(f"{p}.3.w1", width, width)
            ln(f"{p}.3.norm_fn1", width)
            lin(f"{p}.3.w2", width, width)
            ln(f"{p}.3.norm_fn2", width)
    lin("cl_1_fc.0.fc1", r[0], r[0])
    lin("cl_1_fc.0.fc2", r[0], r[1])
    ln("cl_1_fc.1", r[1])
    out["aggregate.weight"], out["aggregate.bias"] = (1, 2, 1), (1,)
    ln("final_norm", r[1])
    for t, n in spec["tasks"]:
        lin(f"head.{t}.fc", r[1], n)
    return out


# ---------------------------------------------------------------------------
# products, in float32 or through the float8 control


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, gradient unchanged."""
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-12)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Ops:
    """The products and convolutions of one forward, float32 or float8."""

    def __init__(self, quant: bool = False):
        self.q = _fp8 if quant else (lambda t: t)

    def linear(self, x, W, name, bias=True):
        y = self.q(x) @ self.q(W[f"{name}.weight"]).t()
        return y + W[f"{name}.bias"] if bias else y

    def conv(self, x, w, b, stride=1, padding=0, groups=1):
        """NHWC conv through an NCHW view."""
        y = F.conv2d(self.q(x).permute(0, 3, 1, 2), self.q(w), b, stride=stride,
                     padding=padding, groups=groups)
        return y.permute(0, 2, 3, 1)

    def bmm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def layer_norm(x, W, name, eps):
    return F.layer_norm(x, (x.shape[-1],), W[f"{name}.weight"], W[f"{name}.bias"], eps)


def gelu(x):
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# blocks


def convnext_block(ops, W, p, x, drop):
    C = x.shape[-1]
    y = ops.conv(x, W[f"{p}.dwconv.weight"], W[f"{p}.dwconv.bias"], padding=3, groups=C)
    y = layer_norm(y, W, f"{p}.norm", 1e-6)
    y = ops.linear(gelu(ops.linear(y, W, f"{p}.pwconv1")), W, f"{p}.pwconv2")
    return x + drop(y * W[f"{p}.gamma"])


def rope_angles(freqs, gh, gw):
    """(N_img, H, D/2) angles of a gh x gw grid, row-major tokens."""
    t = torch.arange(gh * gw, dtype=torch.float32, device=freqs.device)
    tx, ty = t % gw, torch.floor(t / gw)
    return tx[:, None, None] * freqs[0][None] + ty[:, None, None] * freqs[1][None]


def rotate(x, cos, sin):
    """Rotate interleaved (even, odd) feature pairs of (B, N, H, D)."""
    B, N, H, D = x.shape
    pairs = x.reshape(B, N, H, D // 2, 2)
    xe, xo = pairs[..., 0], pairs[..., 1]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1).reshape(B, N, H, D)


def attention(ops, W, p, x, heads, grid, n_extra):
    B, N, C = x.shape
    hd = C // heads
    q, k, v = ops.linear(x, W, f"{p}.attn.qkv").view(B, N, 3, heads, hd).unbind(2)
    ang = rope_angles(W[f"{p}.attn.freqs"], *grid)
    cos = torch.cat([torch.ones_like(ang[:n_extra]), torch.cos(ang)]) if n_extra else torch.cos(ang)
    sin = torch.cat([torch.zeros_like(ang[:n_extra]), torch.sin(ang)]) if n_extra else torch.sin(ang)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, hd)
    probs = torch.softmax(ops.bmm(q * hd ** -0.5, k.transpose(-1, -2)), dim=-1)
    out = ops.bmm(probs, v).transpose(1, 2).reshape(B, N, C)
    return ops.linear(out, W, f"{p}.attn.proj")


def rope_block(ops, W, p, x, heads, grid, n_extra, drop):
    x = x + drop(attention(ops, W, p, layer_norm(x, W, f"{p}.norm1", 1e-5), heads, grid, n_extra))
    h = layer_norm(x, W, f"{p}.norm2", 1e-5)
    return x + drop(ops.linear(gelu(ops.linear(h, W, f"{p}.mlp.fc1")), W, f"{p}.mlp.fc2"))


def meta_head(ops, W, p, m):
    h = layer_norm(F.relu(ops.linear(m, W, f"{p}.0")), W, f"{p}.2", 1e-5)
    y = layer_norm(F.relu(ops.linear(h, W, f"{p}.3.w1")), W, f"{p}.3.norm_fn1", 1e-5)
    y = layer_norm(F.relu(ops.linear(y, W, f"{p}.3.w2")), W, f"{p}.3.norm_fn2", 1e-5)
    return h + y


def extras(ops, W, spec, stage, meta, B):
    tokens = [W[f"cls_token_{stage}"].expand(B, -1, -1)]
    start = 0
    for name, dim in spec["meta"]:
        tokens.append(meta_head(ops, W, f"meta_{name.lower()}_head_{stage}",
                                meta[:, start:start + dim])[:, None, :])
        start += dim
    return torch.cat(tokens, dim=1)


def drop_path_rates(spec) -> list[float]:
    total = sum(spec["cdepths"]) + sum(spec["rdepths"])
    return [float(r) for r in np.linspace(0.0, spec["drop_path_rate"], total)]


def forward(W: dict, images: torch.Tensor, meta: torch.Tensor, spec: dict,
            draw=None, quant: bool = False):
    """float32 logits by task of ``images`` (B, H, W, 3), already scaled as
    the model takes them, and the packed metadata ``meta`` (B, A).
    ``draw(shape)`` gives the uniform draws of stochastic depth in layer
    order (training); None is inference."""
    ops = Ops(quant)
    rates = iter(drop_path_rates(spec))
    B = images.shape[0]

    def dropper(rate):
        def drop(y):
            if draw is None or rate <= 0.0:
                return y
            keep = 1.0 - rate
            mask = draw((B,) + (1,) * (y.dim() - 1)) < keep
            return torch.where(mask, y / keep, torch.zeros_like(y))
        return drop

    c, r = spec["cdims"], spec["rdims"]
    x = ops.conv(images, W["stem.0.weight"], W["stem.0.bias"], stride=4)
    x = layer_norm(x, W, "stem.1", 1e-6)
    for s in (0, 1):
        if s:
            x = ops.conv(layer_norm(x, W, "downsample_layers.0.norm", 1e-6),
                         W["downsample_layers.0.conv.weight"], W["downsample_layers.0.conv.bias"],
                         stride=2)
        for j in range(spec["cdepths"][s]):
            x = convnext_block(ops, W, f"stages.{s}.{j}", x, dropper(next(rates)))
    x = ops.conv(layer_norm(x, W, "downsample_layers.1.norm", 1e-6),
                 W["downsample_layers.1.conv.weight"], W["downsample_layers.1.conv.bias"], stride=2)
    n_extra = 1 + len(spec["meta"])
    g3 = (spec["img"] // 16, spec["img"] // 16)
    g4 = (spec["img"] // 32, spec["img"] // 32)
    dp_rates = [next(rates) for _ in range(sum(spec["rdepths"]))]
    x = torch.cat([extras(ops, W, spec, 1, meta, B), x.reshape(B, g3[0] * g3[1], r[0])], dim=1)
    for j in range(spec["rdepths"][0]):
        x = rope_block(ops, W, f"stages.2.{j}", x, spec["heads"][0], g3, n_extra,
                       dropper(dp_rates[j]))
    x = layer_norm(x, W, "norm_1", 1e-5)
    cls_1 = ops.linear(gelu(ops.linear(x[:, 0:1], W, "cl_1_fc.0.fc1")), W, "cl_1_fc.0.fc2")
    cls_1 = layer_norm(cls_1, W, "cl_1_fc.1", 1e-5)
    x = x[:, n_extra:].reshape(B, g3[0], g3[1], r[0])
    x = ops.conv(layer_norm(x, W, "downsample_layers.2.norm", 1e-6),
                 W["downsample_layers.2.conv.weight"], W["downsample_layers.2.conv.bias"], stride=2)
    x = torch.cat([extras(ops, W, spec, 2, meta, B), x.reshape(B, g4[0] * g4[1], r[1])], dim=1)
    for j in range(spec["rdepths"][1]):
        x = rope_block(ops, W, f"stages.3.{j}", x, spec["heads"][1], g4, n_extra,
                       dropper(dp_rates[spec["rdepths"][0] + j]))
    x = layer_norm(x, W, "norm_2", 1e-5)
    pair = torch.cat([cls_1, x[:, 0:1]], dim=1)  # (B, 2, D)
    feats = (pair * W["aggregate.weight"][0, :, 0][None, :, None]).sum(dim=1) + W["aggregate.bias"]
    feats = layer_norm(feats, W, "final_norm", 1e-5)
    return {t: ops.linear(feats, W, f"head.{t}.fc") for t, _ in spec["tasks"]}
