"""Device time by kernel of the train step, and of the MoE layers' forward.

Port of linnaeus_tpu/tools/profile_step.py over torch.profiler (the TPU
tool reads an xplane through xprof). Three tables, each from one profiled
window of the card:

* ``step``: ``tools/train_bench.py::profile`` of the train step (mFormerV1_sm,
  or mFormerV1_sm_moe with ``--moe``): device ms per step by kernel name
  (``utils/device.py::profiled_device_rows``), the device-busy time (the
  union of the device's operations) and the idle share under the profiler;
* ``moe_forward`` (``--moe``): the MoE layers' forward alone. Each
  ``MoEMlp`` forward is the model's own ``MoEMlp.forward`` span
  (utils/tracing.py), a ``record_function`` range while the profiler
  records; every kernel the card ran inside such a range is summed by
  name and classed as a matrix product (the router's float32 projection
  and the experts' two batched products: the cuBLAS kernels) or the rest
  (the router's softmax and sort, the slot positions, the dispatch into
  the slot buffer, the GELU, the gather and weighted sum with the gates,
  the statistics);
* ``moe_vs_dense`` (``--moe``): the step's kernels against the same step of
  the dense mFormerV1_sm (same seed, batch and kernels), by name: what the
  three MoE layers add or take away per step, backward included.

    python -m linnaeus_tpu_torch.tools.profile_step --moe --steps 3
    python -m linnaeus_tpu_torch.tools.profile_step --steps 3 --out prof.json

It runs on the CUDA device; without one it raises.
"""

from __future__ import annotations

import argparse
import json

import torch

from linnaeus_tpu_torch.utils.device import resolve_device

GEMM_MARKERS = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "cublas", "wgmma")


def is_gemm(name: str) -> bool:
    return any(m in name.lower() for m in GEMM_MARKERS)


def _within(intervals: list[tuple[float, float]], t: float) -> bool:
    return any(lo <= t < hi for lo, hi in intervals)


def moe_forward_breakdown(batch: int = 64, img: int = 384, kernels: bool = True,
                          steps: int = 3, device=None, training: bool = True) -> dict:
    """Device ms per forward of the MoE layers by kernel name (see the module
    docstring), over ``steps`` forwards of mFormerV1_sm_moe after two
    warm-ups; ``training`` runs them as the train step does (training mode,
    gradients recorded), else in inference mode."""
    from torch.profiler import ProfilerActivity

    from linnaeus_tpu_torch.models.blocks.moe import MoEMlp
    from linnaeus_tpu_torch.tools import train_bench

    device = resolve_device(device)
    run, state = train_bench.build_step(batch, img, kernels, device=device, moe=True)
    model = state.model.train(training)
    layers = [m for m in model.modules() if isinstance(m, MoEMlp)]
    g = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(batch, img, img, 3, generator=g, device=device)
    aux = torch.randn(batch, sum(d for _, d in train_bench.META_COMPONENTS), generator=g,
                      device=device)

    def forward() -> None:
        with torch.set_grad_enabled(training), torch.inference_mode(not training):
            model(x, aux)

    for _ in range(2):
        forward()
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            forward()
        torch.cuda.synchronize(device)
    events = [e for e in prof.events() if "cuda" in str(e.device_type).lower()]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "MoEMlp.forward"]
    rows: dict[str, list] = {}
    for e in events:
        if e.name == "MoEMlp.forward" or not _within(spans, e.time_range.start):
            continue
        row = rows.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1000.0 / steps
        row[1] += 1
    table = sorted(({"name": k[:100], "ms_per_forward": v[0], "launches_per_forward": v[1] / steps,
                     "class": "products" if is_gemm(k) else "rest"} for k, v in rows.items()),
                   key=lambda r: -r["ms_per_forward"])
    return {
        "moe_layers": len(layers), "training": training, "device_ranges": len(spans),
        "moe_ms_per_forward": sum(r["ms_per_forward"] for r in table),
        "products_ms_per_forward": sum(r["ms_per_forward"] for r in table
                                       if r["class"] == "products"),
        "rest_ms_per_forward": sum(r["ms_per_forward"] for r in table
                                   if r["class"] == "rest"),
        "kernels": table,
    }


def _by_name(rows: list[dict]) -> dict[str, list[float]]:
    """ms and launches per step by (shortened) kernel name, summed: kernels
    whose names differ past the shortening fall into one row."""
    out: dict[str, list[float]] = {}
    for r in rows:
        acc = out.setdefault(r["name"], [0.0, 0.0])
        acc[0] += r["ms_per_step"]
        acc[1] += r["launches_per_step"]
    return out


def versus_dense(moe_rows: list[dict], dense_rows: list[dict]) -> list[dict]:
    """Per kernel name: ms per step with MoE minus without, largest first."""
    moe, dense = _by_name(moe_rows), _by_name(dense_rows)
    out = []
    for name in set(moe) | set(dense):
        (a_ms, a_n), (b_ms, b_n) = moe.get(name, (0.0, 0.0)), dense.get(name, (0.0, 0.0))
        out.append({"name": name, "moe_ms": a_ms, "dense_ms": b_ms, "delta_ms": a_ms - b_ms,
                    "moe_launches": a_n, "dense_launches": b_n})
    return sorted(out, key=lambda r: -abs(r["delta_ms"]))


def main(argv=None) -> None:
    from linnaeus_tpu_torch.tools import train_bench

    p = argparse.ArgumentParser("profile_step")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--img", type=int, default=384)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--no-kernels", action="store_true",
                   help="plain PyTorch attention and MLP instead of K1 and K2")
    p.add_argument("--moe", action="store_true",
                   help="the mFormerV1_sm_moe train step, the MoE layers' forward by kernel "
                        "and the step against the dense one")
    p.add_argument("--out", default=None, help="also write every table as JSON here")
    args = p.parse_args(argv)
    kernels = not args.no_kernels
    step = train_bench.profile(args.batch, args.img, kernels, steps=args.steps, top=10**6,
                               moe=args.moe)
    result = {"step": step}
    if args.moe:
        result["moe_forward"] = moe_forward_breakdown(args.batch, args.img, kernels,
                                                      steps=args.steps)
        dense = train_bench.profile(args.batch, args.img, kernels, steps=args.steps, top=10**6)
        result["dense_step"] = {k: v for k, v in dense.items() if k != "top"}
        result["moe_vs_dense"] = versus_dense(step["top"], dense["top"])
    print(f"step: {step['device_busy_ms_per_step']:.3f} ms device-busy per step of "
          f"{step['wall_ms_per_step']:.3f} ms under the profiler (idle share "
          f"{step['idle_share']:.3f})")
    for r in step["top"][:args.top]:
        print(f"  {r['ms_per_step']:9.3f} ms {r['launches_per_step']:6.1f}x  {r['name']}")
    if args.moe:
        f = result["moe_forward"]
        print(f"MoE layers' forward ({f['moe_layers']} layers, {f['device_ranges']} ranges on "
              f"the device): {f['moe_ms_per_forward']:.3f} ms, matrix products "
              f"{f['products_ms_per_forward']:.3f} ms, the rest (routing, dispatch, GELU, "
              f"combine, statistics) {f['rest_ms_per_forward']:.3f} ms")
        for r in f["kernels"]:
            print(f"  {r['ms_per_forward']:9.3f} ms {r['launches_per_forward']:6.1f}x  "
                  f"{r['class']:<8} {r['name']}")
        d = result["dense_step"]
        print(f"against the dense step ({d['device_busy_ms_per_step']:.3f} ms device-busy):")
        for r in result["moe_vs_dense"][:args.top]:
            print(f"  {r['delta_ms']:+9.3f} ms ({r['moe_launches']:.0f} vs "
                  f"{r['dense_launches']:.0f}x)  {r['name'][:100]}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh)
    print(json.dumps({k: v for k, v in result.items() if k == "moe_forward"} | {
        "device_busy_ms_per_step": step["device_busy_ms_per_step"],
        "idle_share": step["idle_share"]}))


if __name__ == "__main__":
    main()
