"""Image augmentation ops on batches of float32 images on the device.

Port of linnaeus_tpu/data/augmentation/ops.py. Where the TPU package writes
each op for one (H, W, 3) image and vmaps it, each op here takes a batch
(n, H, W, 3) in [0, 1] and per-sample parameters as (n,) tensors: the
magnitude (0-10, timm's AutoAugment conventions: rotate <= 30 degrees, shear
<= 0.3, translate <= 0.45 of the size, enhance factors 1 +- 0.9 m / 10) and
the op's random value, drawn by the caller (the sign of a geometric or
enhance op, the sigma of the blur), so that a test can hand in the TPU
package's own draws. ``random_erasing`` takes its boxes and fill, and
``color_jitter`` its three factors, the same way. Every op is plain
PyTorch: the TPU package has no kernel of its own here.

The affine ops resample bilinearly with a constant 0.5 outside the image
(``map_coordinates(order=1, mode="constant", cval=0.5)`` there):
``F.grid_sample`` with ``align_corners=True`` on ``img - 0.5`` with zero
padding, plus 0.5, which treats every out-of-range corner of the bilinear
stencil as 0.5, as ``map_coordinates`` does. Equalize builds PIL's
per-channel 256-bin histograms with one ``scatter_add`` over (n, 3, 256).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

MAX_MAG = 10.0
_GRAY = (0.299, 0.587, 0.114)


def _param(magnitude, like: torch.Tensor, fn: Callable) -> torch.Tensor:
    """``fn`` of the magnitude (a number or an (n,) tensor) in float64, then
    in ``like``'s dtype and on its device, as (n,): the TPU package derives
    each op's constant from its magnitude in Python floats before it meets
    the image, and this rounds the same way."""
    m = torch.as_tensor(magnitude, dtype=torch.float64)
    return fn(m).to(device=like.device, dtype=like.dtype).reshape(-1)


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-sample (n,) value as (n, 1, 1, 1)."""
    return v.reshape(-1, 1, 1, 1)


def rand_sign(u: torch.Tensor) -> torch.Tensor:
    """+1 where the uniform draw is below 0.5, else -1 (JAX's
    ``_rand_sign``: ``bernoulli(key, 0.5)`` is ``uniform(key) < 0.5``)."""
    return torch.where(u < 0.5, 1.0, -1.0).to(u.dtype)


# ---------------------------------------------------------------- geometric
def affine_sample(img: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Resample each image by its inverse 2x3 matrix (n, 2, 3), which maps
    centred output (y, x) pixel coordinates to input ones."""
    n, H, W, _ = img.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=img.device, dtype=img.dtype),
                            torch.arange(W, device=img.device, dtype=img.dtype), indexing="ij")
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yc, xc = ys - cy, xs - cx
    m = matrix.to(img.dtype)[:, :, :, None, None]  # (n, 2, 3, 1, 1)
    src_y = m[:, 0, 0] * yc + m[:, 0, 1] * xc + m[:, 0, 2] + cy
    src_x = m[:, 1, 0] * yc + m[:, 1, 1] * xc + m[:, 1, 2] + cx
    grid = torch.stack([src_x * (2.0 / (W - 1)) - 1.0, src_y * (2.0 / (H - 1)) - 1.0], dim=-1)
    out = F.grid_sample((img - 0.5).permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1) + 0.5


def _matrix(a, b, c, d, e, f) -> torch.Tensor:
    rows = [torch.stack(torch.broadcast_tensors(a, b, c), -1),
            torch.stack(torch.broadcast_tensors(d, e, f), -1)]
    return torch.stack(rows, dim=-2)


def _affine(img, entries) -> torch.Tensor:
    n = img.shape[0]
    vals = [torch.as_tensor(v, dtype=img.dtype, device=img.device).expand(n) for v in entries]
    return affine_sample(img, _matrix(*vals))


def rotate(img, magnitude, sign):
    angle = torch.deg2rad(_param(magnitude, img, lambda m: 30.0 * m / MAX_MAG)) * sign
    c, s = torch.cos(angle), torch.sin(angle)
    return _affine(img, (c, -s, 0.0, s, c, 0.0))


def shear_x(img, magnitude, sign):
    k = _param(magnitude, img, lambda m: 0.3 * m / MAX_MAG) * sign
    return _affine(img, (1.0, 0.0, 0.0, k, 1.0, 0.0))


def shear_y(img, magnitude, sign):
    k = _param(magnitude, img, lambda m: 0.3 * m / MAX_MAG) * sign
    return _affine(img, (1.0, k, 0.0, 0.0, 1.0, 0.0))


def translate_x_rel(img, magnitude, sign):
    shift = _param(magnitude, img, lambda m: 0.45 * m / MAX_MAG * img.shape[2]) * sign
    return _affine(img, (1.0, 0.0, 0.0, 0.0, 1.0, shift))


def translate_y_rel(img, magnitude, sign):
    shift = _param(magnitude, img, lambda m: 0.45 * m / MAX_MAG * img.shape[1]) * sign
    return _affine(img, (1.0, 0.0, shift, 0.0, 1.0, 0.0))


# ------------------------------------------------------------------- color
def grayscale(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_GRAY, dtype=img.dtype, device=img.device)
    return (img * w).sum(-1, keepdim=True).expand(img.shape)


def _blend(a, b, factor):
    return torch.clamp(b + factor * (a - b), 0.0, 1.0)


def _enhance_factor(magnitude, sign, like):
    step = _param(magnitude, like, lambda m: 0.9 * m / MAX_MAG)
    return _col(1.0 + step * torch.as_tensor(sign, dtype=like.dtype, device=like.device))


def color(img, magnitude, sign):
    return _blend(img, grayscale(img), _enhance_factor(magnitude, sign, img))


def contrast(img, magnitude, sign):
    mean = grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(img, mean.expand(img.shape), _enhance_factor(magnitude, sign, img))


def brightness(img, magnitude, sign):
    return _blend(img, torch.zeros_like(img), _enhance_factor(magnitude, sign, img))


def _conv2d_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Each channel of each image correlated with ``kernel`` (kh, kw), or
    with its own kernel (n, kh, kw), zero-padded to the same size."""
    n, H, W, C = img.shape
    kh, kw = kernel.shape[-2:]
    x = img.permute(0, 3, 1, 2).reshape(1, n * C, H, W)
    if kernel.dim() == 2:
        weight = kernel.to(img.dtype).expand(n * C, 1, kh, kw)
    else:
        weight = kernel.to(img.dtype)[:, None, None].expand(n, C, 1, kh, kw).reshape(
            n * C, 1, kh, kw)
    out = F.conv2d(x, weight, padding=(kh // 2, kw // 2), groups=n * C)
    return out.reshape(n, C, H, W).permute(0, 2, 3, 1)


def sharpness(img, magnitude, sign):
    kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=img.dtype,
                          device=img.device) / 13.0
    return _blend(img, _conv2d_same(img, kernel), _enhance_factor(magnitude, sign, img))


def desaturate(img, magnitude, value=None):
    return _blend(grayscale(img), img, _col(_param(magnitude, img, lambda m: m / MAX_MAG)))


def invert(img, magnitude=None, value=None):
    return 1.0 - img


def solarize(img, magnitude, value=None):
    threshold = _col(_param(magnitude, img, lambda m: 1.0 - m / MAX_MAG))
    return torch.where(img >= threshold, 1.0 - img, img)


def solarize_add(img, magnitude, value=None):
    add = _col(_param(magnitude, img, lambda m: (110.0 / 255.0) * m / MAX_MAG))
    return torch.where(img < 0.5, torch.clamp(img + add, 0.0, 1.0), img)


def _posterize_bits(img, bits):
    levels = torch.pow(2.0, bits.to(img.dtype))
    step = 256.0 / levels
    q = torch.floor(img * 255.0 / step) * step
    return torch.clamp(q / 255.0, 0.0, 1.0)


def posterize_original(img, magnitude, value=None):
    bits = _col(_param(magnitude, img, lambda m: 4 + torch.floor(4 * (1 - m / MAX_MAG))))
    return _posterize_bits(img, bits)


def posterize_increasing(img, magnitude, value=None):
    bits = _col(_param(magnitude, img, lambda m: 8 - torch.floor(4 * m / MAX_MAG)))
    return _posterize_bits(img, bits)


def autocontrast(img, magnitude=None, value=None):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.ones_like(hi))
    return torch.clamp((img - lo) * scale, 0.0, 1.0)


def equalize(img, magnitude=None, value=None):
    """PIL-style equalisation per image and channel: a 256-bin histogram of
    the pixels quantised to int(255 x), step = (total - count of the last
    non-empty bin) / 255, and the look-up table (cdf - hist / 2) / step
    clipped to [0, 255] (the identity where step is 0), as floats."""
    n, H, W, C = img.shape
    q = torch.clamp((img * 255.0).to(torch.int64), 0, 255)
    qc = q.permute(0, 3, 1, 2).reshape(n, C, H * W)
    hist = torch.zeros(n, C, 256, dtype=img.dtype, device=img.device)
    hist.scatter_add_(2, qc, torch.ones_like(qc, dtype=img.dtype))
    nonzero = hist > 0
    last_idx = 255 - nonzero.flip(-1).to(torch.int64).argmax(dim=-1, keepdim=True)
    step = (hist.sum(-1, keepdim=True) - hist.gather(2, last_idx)) / 255.0
    cdf = hist.cumsum(-1)
    ramp = torch.arange(256, dtype=img.dtype, device=img.device).expand_as(hist)
    lut = torch.where(step > 0, torch.clamp((cdf - hist / 2.0) / step.clamp_min(1e-8), 0, 255),
                      ramp)
    out = lut.gather(2, qc) / 255.0
    return out.reshape(n, C, H, W).permute(0, 2, 3, 1)


def blur_sigma(u: torch.Tensor, magnitude) -> torch.Tensor:
    """GaussianBlurRand's sigma from a uniform draw: uniform in
    [0.1, max(2 m / 10, 0.1)), as ``jax.random.uniform`` maps it."""
    max_sigma = _param(magnitude, u, lambda m: torch.clamp(2.0 * m / MAX_MAG, min=0.1))
    return (u * (max_sigma - 0.1) + 0.1).clamp_min(0.1)


def gaussian_blur_rand(img, magnitude, sigma):
    """9x9 Gaussian blur with each image's own ``sigma`` (n,)."""
    radius = 4
    xs = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k1d = torch.exp(-0.5 * (xs[None, :] / torch.as_tensor(sigma, dtype=img.dtype).reshape(-1, 1))
                    ** 2)
    k1d = k1d / k1d.sum(-1, keepdim=True)
    return _conv2d_same(img, k1d[:, :, None] * k1d[:, None, :])


# ------------------------------------------------------- erasing, jitter
def erase_boxes(u: torch.Tensor, H: int, W: int, area_range=(0.02, 0.4),
                aspect_range=(0.3, 3.3)) -> torch.Tensor:
    """(n, 4) int64 boxes (y0, x0, height, width) from uniform draws u (n, 4):
    the area fraction, the log aspect ratio, and the two corner draws, as
    the TPU package's ``random_erasing`` derives them."""
    area = u[:, 0] * (area_range[1] - area_range[0]) + area_range[0]
    lo, hi = math.log(aspect_range[0]), math.log(aspect_range[1])
    aspect = torch.exp(u[:, 1] * (hi - lo) + lo)
    target = area * H * W
    eh = torch.clamp(torch.sqrt(target * aspect), 1, H - 1).to(torch.int64)
    ew = torch.clamp(torch.sqrt(target / aspect), 1, W - 1).to(torch.int64)
    y0 = torch.floor(u[:, 2] * (H - eh + 1)).to(torch.int64)
    x0 = torch.floor(u[:, 3] * (W - ew + 1)).to(torch.int64)
    return torch.stack([y0, x0, eh, ew], dim=-1)


def random_erasing(img: torch.Tensor, boxes: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """Replace each image's box (n, 4: y0, x0, height, width) by ``fill``
    (n, H, W, 3) clipped to [0, 1]."""
    n, H, W, _ = img.shape
    ys = torch.arange(H, device=img.device)[None, :, None, None]
    xs = torch.arange(W, device=img.device)[None, None, :, None]
    y0, x0, eh, ew = (boxes[:, i].reshape(-1, 1, 1, 1) for i in range(4))
    mask = (ys >= y0) & (ys < y0 + eh) & (xs >= x0) & (xs < x0 + ew)
    return torch.where(mask, torch.clamp(fill, 0.0, 1.0), img)


def color_jitter(img: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast and saturation jitter by per-image factors
    (n, 3), each uniform in [1 - s, 1 + s] (AUG.AUTOAUG.COLOR_JITTER = s)."""
    fb, fc, fs = (factors[:, i].reshape(-1, 1, 1, 1).to(img.dtype) for i in range(3))
    img = torch.clamp(img * fb, 0.0, 1.0)
    mean = grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    img = torch.clamp(mean + (img - mean) * fc, 0.0, 1.0)
    gray = grayscale(img)
    return torch.clamp(gray + (img - gray) * fs, 0.0, 1.0)


OP_REGISTRY: dict[str, Callable] = {
    "Rotate": rotate,
    "ShearX": shear_x,
    "ShearY": shear_y,
    "TranslateXRel": translate_x_rel,
    "TranslateYRel": translate_y_rel,
    "Color": color,
    "Contrast": contrast,
    "Brightness": brightness,
    "Sharpness": sharpness,
    "Desaturate": desaturate,
    "Invert": invert,
    "Solarize": solarize,
    "SolarizeAdd": solarize_add,
    "PosterizeOriginal": posterize_original,
    "PosterizeIncreasing": posterize_increasing,
    "AutoContrast": autocontrast,
    "Equalize": equalize,
    "GaussianBlurRand": gaussian_blur_rand,
}
SIGNED_OPS = frozenset({"Rotate", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
                        "Color", "Contrast", "Brightness", "Sharpness"})


def op_value(name: str, u: torch.Tensor, magnitude) -> torch.Tensor | None:
    """The random value op ``name`` takes, from its uniform draw ``u``: the
    sign of a geometric or enhance op, the blur's sigma, else None."""
    if name in SIGNED_OPS:
        return rand_sign(u)
    if name == "GaussianBlurRand":
        return blur_sigma(u, magnitude)
    return None
