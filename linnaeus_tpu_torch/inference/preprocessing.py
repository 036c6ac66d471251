"""Inference preprocessing: images to uint8 NHWC rows, metadata to the packed
aux vector.

Port of linnaeus_tpu/inference/preprocessing.py. Normalisation happens on
the device (the handler's forward); here images are only brought to uint8
(H, W, C) at the configured size. A batch of JPEG bytes decodes in one call
to the host data plane (linnaeus_tpu_torch/native/: DCT-prescaled decode and
area resize in threads off the GIL); any other input, and any row the data
plane cannot decode, goes through PIL one image at a time. PIL is imported
only to decode bytes or PIL images and to resize: a uint8 array already at
size needs neither.
"""

from __future__ import annotations

import io
from datetime import datetime
from typing import Any

import numpy as np

from .config import InferenceConfig
from .projections import (
    datetime_to_temporal_sinusoids,
    elevation_to_sinusoids,
    latlon_to_unit_sphere,
)


def _to_array(image: Any) -> np.ndarray:
    if isinstance(image, bytes):
        from PIL import Image

        image = Image.open(io.BytesIO(image))
    if hasattr(image, "convert"):  # a PIL image
        image = np.asarray(image.convert("RGB"))
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    return image


def preprocess_image_u8(image: Any, cfg: InferenceConfig) -> np.ndarray:
    """-> uint8 (H, W, C) RGB at the configured size, not normalised.

    Float inputs are quantised (values <= 1.5 are taken as [0, 1]-scaled);
    integer inputs wider than uint8 are rescaled by their dtype range only
    when their 99.9th percentile exceeds 255, and clipped otherwise."""
    c, h, w = cfg.input_preprocessing.image_size
    arr = _to_array(image)
    if np.issubdtype(arr.dtype, np.floating):
        if arr.size and float(arr.max()) <= 1.5:
            arr = arr * 255.0
        arr = np.clip(arr, 0.0, 255.0)
    elif np.issubdtype(arr.dtype, np.integer) and arr.dtype != np.uint8:
        info = np.iinfo(arr.dtype)
        if info.max > 255 and arr.size and float(np.percentile(arr, 99.9)) > 255.0:
            arr = arr.astype(np.float64) * (255.0 / info.max)
        arr = np.clip(arr, 0, 255)
    arr = arr.astype(np.uint8)
    if arr.shape[0] != h or arr.shape[1] != w:
        from PIL import Image

        interp = {
            "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC,
            "nearest_exact": Image.NEAREST,
            "nearest": Image.NEAREST,
        }.get(cfg.input_preprocessing.image_interpolation, Image.BILINEAR)
        arr = np.asarray(Image.fromarray(arr).resize((w, h), interp))
    return arr


def preprocess_image_batch(images: list[Any], cfg: InferenceConfig) -> np.ndarray:
    """-> uint8 (B, H, W, C).

    When the target is square, the interpolation bilinear and every input
    JPEG bytes, the whole batch decodes in the host data plane
    (``get_dataplane()``; area resize, the anti-aliased downscale PIL's
    resize also applies). A row it cannot decode goes through
    ``preprocess_image_u8``, so it raises what the PIL path raises; any
    other batch goes through that path whole."""
    c, h, w = cfg.input_preprocessing.image_size
    if (
        h == w
        and cfg.input_preprocessing.image_interpolation == "bilinear"
        and images
        and all(isinstance(im, bytes) and im[:2] == b"\xff\xd8" for im in images)
    ):
        from linnaeus_tpu_torch.native import get_dataplane

        dp = get_dataplane()
        if dp is not None:
            arr, status = dp.decode_jpeg_mem_batch(list(images), h)
            for i in np.nonzero(status != 0)[0]:
                arr[i] = preprocess_image_u8(images[i], cfg)
            return arr
    return np.stack([preprocess_image_u8(im, cfg) for im in images])


def preprocess_metadata(meta: dict[str, Any] | None, cfg: InferenceConfig) -> np.ndarray:
    """One sample's metadata dict -> the packed aux vector.

    Keys: ``lat``/``lon`` (or ``latitude``/``longitude``), ``datetime``
    (datetime or ISO string), ``elevation_m`` (or ``elevation``). A missing
    component encodes as zeros (the model's masked signal)."""
    mc = cfg.metadata_preprocessing
    chunks: list[np.ndarray] = []
    meta = meta or {}

    if mc.use_temporal:
        dt = meta.get("datetime")
        if isinstance(dt, str):
            dt = datetime.fromisoformat(dt)
        if dt is not None:
            chunks.append(datetime_to_temporal_sinusoids(
                dt, use_jd=mc.temporal_use_julian_day, use_hour=mc.temporal_use_hour))
        else:
            chunks.append(np.zeros(4 if mc.temporal_use_hour else 2, np.float32))

    if mc.use_geolocation:
        lat = meta.get("lat", meta.get("latitude"))
        lon = meta.get("lon", meta.get("longitude"))
        if lat is not None and lon is not None:
            chunks.append(latlon_to_unit_sphere(float(lat), float(lon)))
        else:
            chunks.append(np.zeros(3, np.float32))

    if mc.use_elevation:
        elev = meta.get("elevation_m", meta.get("elevation"))
        if elev is not None:
            chunks.append(elevation_to_sinusoids(float(elev), mc.elevation_scales))
        else:
            chunks.append(np.zeros(2 * len(mc.elevation_scales), np.float32))

    if not chunks:
        return np.zeros(0, np.float32)
    vec = np.concatenate(chunks)
    expected = cfg.model.expected_aux_vector_length
    if expected is not None and len(vec) != expected:
        fixed = np.zeros(expected, np.float32)
        fixed[: min(expected, len(vec))] = vec[:expected]
        vec = fixed
    return vec


def preprocess_metadata_batch(
    metas: list[dict[str, Any] | None] | None, batch_size: int, cfg: InferenceConfig
) -> np.ndarray:
    if metas is None:
        metas = [None] * batch_size
    return np.stack([preprocess_metadata(m, cfg) for m in metas])
