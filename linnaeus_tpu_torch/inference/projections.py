"""Metadata feature projections (typus-compatible).

Port of linnaeus_tpu/inference/projections.py, unchanged: numpy only.

  * temporal: sinusoidal month-of-year (or day-of-year) pair, optional
    hour-of-day pair -> dim 2 or 4
  * geolocation: (lat, lon) -> unit-sphere (x, y, z) -> dim 3
  * elevation: sin/cos at multiple scales -> dim 2 * len(scales)
"""

from __future__ import annotations

import math
from datetime import datetime

import numpy as np


def datetime_to_temporal_sinusoids(
    dt: datetime, use_jd: bool = False, use_hour: bool = False
) -> np.ndarray:
    if use_jd:
        day = dt.timetuple().tm_yday
        phase = 2 * math.pi * (day - 1) / 365.0
    else:
        phase = 2 * math.pi * (dt.month - 1 + (dt.day - 1) / 31.0) / 12.0
    feats = [math.sin(phase), math.cos(phase)]
    if use_hour:
        hphase = 2 * math.pi * dt.hour / 24.0
        feats += [math.sin(hphase), math.cos(hphase)]
    return np.asarray(feats, dtype=np.float32)


def latlon_to_unit_sphere(lat: float, lon: float) -> np.ndarray:
    lat_r, lon_r = math.radians(lat), math.radians(lon)
    return np.asarray(
        [
            math.cos(lat_r) * math.cos(lon_r),
            math.cos(lat_r) * math.sin(lon_r),
            math.sin(lat_r),
        ],
        dtype=np.float32,
    )


def elevation_to_sinusoids(elevation_m: float, scales: list[float]) -> np.ndarray:
    feats = []
    for s in scales:
        phase = 2 * math.pi * elevation_m / s
        feats += [math.sin(phase), math.cos(phase)]
    return np.asarray(feats, dtype=np.float32)
