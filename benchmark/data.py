"""Inputs made from the seed: a taxonomy and training batches.

Everything bulky is drawn on the device in one call; labels and metadata
dictionaries, which are small, on the host from a numpy generator of the
same seed. The program receives only what this module makes.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def taxonomy(num_classes: dict, seed: int) -> dict:
    """{child task: {class: parent class}} over the tasks (fine -> coarse):
    every class but the null class 0 has a parent among the next coarser
    task's non-null classes."""
    rng = np.random.default_rng(seed)
    keys = list(num_classes)
    return {child: {c: int(rng.integers(1, num_classes[parent]))
                    for c in range(1, num_classes[child])}
            for child, parent in zip(keys[:-1], keys[1:])}


def _children(hierarchy: dict, child_task: str) -> dict:
    out: dict[int, list[int]] = {}
    for c, p in hierarchy[child_task].items():
        out.setdefault(p, []).append(c)
    return out


def aux_columns(meta: list, phase, lat, lon, elev, scales) -> list:
    """The packed metadata vector's columns by component, as the projections
    of the inference config make them (month phase, unit sphere, elevation
    sinusoids)."""
    cols = []
    for name, dim in meta:
        if name == "TEMPORAL":
            cols += [np.sin(phase), np.cos(phase)]
        elif name == "SPATIAL":
            la, lo = np.radians(lat), np.radians(lon)
            cols += [np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)]
        elif name == "ELEVATION":
            for s in scales[:dim // 2]:
                cols += [np.sin(2 * math.pi * elev / s), np.cos(2 * math.pi * elev / s)]
        else:
            raise ValueError(f"no generator for metadata component {name}")
    return cols


def train_ring(spec: dict, hierarchy: dict, batch: int, count: int, seed: int, device,
               scales=(100.0, 1000.0, 5000.0)) -> list[dict]:
    """``count`` distinct batches of ``batch`` rows: uint8 images, packed
    metadata, integer labels consistent with the taxonomy, in pairs that
    share their second-finest rank (the 'mixed-pairs' sampler's batches,
    grouped at that rank)."""
    n = batch * count
    g = torch.Generator(device=device).manual_seed(seed)
    img = spec["img"]
    images = torch.randint(0, 256, (n, img, img, 3), generator=g, device=device,
                           dtype=torch.uint8)
    rng = np.random.default_rng(seed)
    tasks = [t for t, _ in spec["tasks"]]
    sizes = dict(spec["tasks"])
    kids = _children(hierarchy, tasks[0])
    group = rng.integers(1, sizes[tasks[1]], n // 2).repeat(2)
    labels = {tasks[0]: np.array([rng.choice(kids[p]) if p in kids else 0 for p in group]),
              tasks[1]: group}
    for child, parent in zip(tasks[1:-1], tasks[2:]):
        labels[parent] = np.array([hierarchy[child].get(int(c), 0) for c in labels[child]])
    cols = aux_columns(spec["meta"], rng.uniform(0, 2 * math.pi, n), rng.uniform(-60, 70, n),
                       rng.uniform(-180, 180, n), rng.uniform(0, 4000, n), scales)
    aux = torch.from_numpy(np.stack(cols, axis=1).astype(np.float32)).to(device)
    ring = []
    for i in range(count):
        rows = slice(i * batch, (i + 1) * batch)
        ring.append({
            "images": images[rows],
            "aux": aux[rows],
            "targets": {t: torch.from_numpy(labels[t][rows].astype(np.int64)).to(device)
                        for t in tasks},
            "group_ids": torch.from_numpy(group[rows].astype(np.int32)).to(device),
        })
    return ring
