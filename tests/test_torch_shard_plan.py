"""The port's shard_plan against the TPU package's tool and plans.

The JAX tool's own checks (tests/test_tools.py, its tiny mFormerV1) on the
port's plans, each from one real step of rank 0 over torch's fake process
group; per-rank parameter bytes against the TPU package's plan on JAX's
parameter tree (``jax.eval_shape`` and ``PARAM_SHARDING_FNS``, nothing
compiled): equal for dp and ep, and for tp but for the RoPE frequencies,
which a port rank splits with its heads. Under 'fsdp' the TPU package's plan
replicates the leaves no axis of which the data axis divides; FSDP2 shards
those too (along axis 0, a padded last chunk), so the port's rank holds
less: the plan's bytes plus those leaves' rank-0 chunks. The census shows
the two data-parallel repairs: no image row is all-gathered (only the
batch's targets, metadata and group ids; a rank takes its mixing partners'
rows through one all-to-all), and FSDP2 gathers one block at a time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.parallel.mesh import PARAM_SHARDING_FNS as J_FNS
from linnaeus_tpu.tools.shard_plan import _spec_shards
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.parallel.model import fsdp_units
from linnaeus_tpu_torch.tools.shard_plan import build_plan, main
from tests import test_torch_moe_step as ms

NC = {"taxa_L10": 11, "taxa_L20": 5}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
IMG, B = 32, 16


def _spec(rope_depths=(1, 1)):
    return {"CONVNEXT": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
            "ROPE": {"DEPTHS": list(rope_depths), "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
            "DROP_PATH_RATE": 0.0}


def port_model(rope_depths=(1, 1)):
    return build_model(_spec(rope_depths), IMG, NC, META, device="cpu")


def jax_bytes(jm, img, mesh_axes, mode):
    """(total, per device) parameter bytes of the TPU package's plan."""
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((2, img, img, 3), jnp.float32),
                            jax.ShapeDtypeStruct((2, 5), jnp.float32))["params"]
    devices = np.asarray(jax.devices()[:int(np.prod(list(mesh_axes.values())))])
    mesh = JMesh(devices.reshape(tuple(mesh_axes.values())), tuple(mesh_axes))
    shardings = J_FNS[mode](mesh, params)
    total = per = 0
    for leaf, s in zip(jax.tree.leaves(params), jax.tree.leaves(shardings)):
        nb = leaf.size * leaf.dtype.itemsize
        total += nb
        per += nb // _spec_shards(s)
    return total, per


def jax_tiny():
    return JMFormerV1(img_size=(IMG, IMG), convnext_depths=(1, 1, 1, 1),
                      convnext_dims=(8, 16, 32, 64), rope_depths=(1, 1), rope_dims=(32, 64),
                      rope_num_heads=(2, 2), drop_path_rate=0.0, meta_components=META,
                      task_keys=tuple(NC), num_classes=NC,
                      head_configs={t: {"TYPE": "Linear"} for t in NC})


def plan(mode, mesh, model=None, **kw):
    return build_plan("tiny", mesh, mode, B, IMG, model=model or port_model(), num_classes=NC,
                      device="cpu", **kw)


def test_dp_census_matches_params():
    """dp: the gradient all-reduce carries about the parameter bytes; the
    only all-gathers are of the batch's targets, metadata and group ids."""
    p = plan("dp", {"data": 8})
    total, _ = jax_bytes(jax_tiny(), IMG, {"data": 8}, "fsdp")
    assert p["param_bytes_per_device"] == p["param_bytes_total"] == total
    ar = p["collectives_per_step"]["all-reduce"]
    assert 0.75 < ar["bytes"] / p["param_bytes_total"] < 2.5
    assert p["memory_analysis"] is None  # no card: no peak
    ag = p["collectives_per_step"]["all-gather"]
    assert ag["bytes"] < IMG * IMG * 3  # not one image row
    assert p["largest_replicated"][0]["mbytes"] > 0


def test_fsdp_shards_params_one_block_a_gather():
    model = port_model()
    units = fsdp_units(model)
    biggest = max(sum(p.numel() * 4 for p in u.parameters()) for u in units[:-1])
    p = plan("fsdp", {"data": 8}, model=model)
    assert p["param_bytes_per_device"] < p["param_bytes_total"] / 2
    assert p["opt_ema_bytes_per_device"] < p["opt_ema_bytes_total"] / 2
    assert p["params_sharded"] > p["params_total_leaves"] / 2
    census = p["collectives_per_step"]
    # each block gathered for its forward and again for its backward, the
    # root once; the largest gather one unit's parameters, not the model's
    assert census["all-gather"]["count"] == 4 + 2 * (len(units) - 1) + 1
    assert census["all-gather"]["max_bytes"] <= p["largest_unit_bytes"] < p["param_bytes_total"]
    assert p["largest_unit_bytes"] >= biggest  # a block's, padded to the data axis
    assert census["reduce-scatter"]["count"] >= 1


def test_fsdp_bytes_against_the_jax_plan():
    """The plan's bytes are JAX's; the rank also holds its chunk of each
    leaf the plan replicates (FSDP2 shards every parameter)."""
    from linnaeus_tpu_torch.parallel.mesh import Mesh, fsdp_param_sharding

    model = port_model()
    placement = fsdp_param_sharding(Mesh(8, 1), model)
    planned = sum(p.numel() * 4 // (8 if placement[n] else 1)
                  for n, p in model.named_parameters())
    held = sum(p.numel() * 4 // 8 if placement[n] else
               -(-p.shape[0] // 8) * (p.numel() // p.shape[0]) * 4
               for n, p in model.named_parameters())
    _, per = jax_bytes(jax_tiny(), IMG, {"data": 8}, "fsdp")
    assert planned == per
    assert plan("fsdp", {"data": 8}, model=model)["param_bytes_per_device"] == held < per


def test_tp_mesh_bytes_equal_jax():
    """JAX's plan to the byte, but for the RoPE frequencies: the TPU package
    replicates them, a port rank keeps its heads' half (it computes only
    those heads, parallel/model.py::_tp)."""
    model = port_model()
    freqs = sum(p.numel() * 4 for n, p in model.named_parameters() if n.endswith("freqs"))
    p = plan("tp", {"data": 4, "model": 2}, model=model)
    assert p["params_sharded"] > 0 and p["batch_per_device"] == 4
    total, per = jax_bytes(jax_tiny(), IMG, {"data": 4, "model": 2}, "tp")
    assert freqs > 0 and p["param_bytes_total"] == total
    assert p["param_bytes_per_device"] == per - freqs // 2 < total


def test_ep_bytes_equal_jax():
    p = build_plan("tiny", {"data": 4, "model": 2}, "ep", B, ms.IMG, model=ms.port_model(),
                   num_classes=ms.NC, device="cpu")
    total, per = jax_bytes(ms.jax_model(), ms.IMG, {"data": 4, "model": 2}, "ep")
    assert (p["param_bytes_total"], p["param_bytes_per_device"]) == (total, per)
    assert p["collectives_per_step"]["all-to-all"]["count"] >= 2  # the experts' dispatch


def test_pp_mode_sends_stage_to_stage():
    p = plan("pp", {"data": 4, "model": 2}, model=port_model((2, 2)), microbatches=2)
    assert p["param_bytes_per_device"] == p["param_bytes_total"]
    for kind in ("send", "recv"):
        hop = p["collectives_per_step"].get(kind)
        assert hop is not None and hop["count"] >= 1 and hop["bytes"] > 0, kind


def test_partners_on_other_ranks_come_through_one_all_to_all():
    """Every rank at the default config's first mixup group level (taxa_L40,
    29 groups: a row's partner is a random member of its group in the
    global batch): the partner rows arrive by all-to-all, whole image rows,
    at most the rank's own row count."""
    got = []
    for rank in range(4):
        p = plan("dp", {"data": 4}, rank=rank)
        assert p["group_level"] == "taxa_L40"
        a2a = p["collectives_per_step"].get("all-to-all", {"bytes": 0})
        assert a2a["bytes"] % (IMG * IMG * 3) == 0
        assert a2a["bytes"] <= (B // 4) * IMG * IMG * 3
        assert p["partner_fetch"]["taxa_L40"]["bytes"] == a2a["bytes"]
        got.append(a2a["bytes"])
    assert sum(got) > 0


def test_each_group_level_reports_its_partner_fetch():
    """One step a level of SCHEDULE.MIX.GROUP_LEVELS on 'mixed-pairs'
    batches of scale_receipt's labels: at taxa_L10 a partner is mostly the
    row's pair-mate, on its own rank; at the coarsest level most partners
    live on other ranks."""
    p = build_plan("tiny", {"data": 8}, "dp", 128, IMG, model=port_model(), num_classes=NC,
                   device="cpu")
    fetch = p["partner_fetch"]
    assert list(fetch) == ["taxa_L40", "taxa_L30", "taxa_L20", "taxa_L10"]
    assert all(v["bytes"] == v["rows"] * IMG * IMG * 3 for v in fetch.values())
    assert fetch["taxa_L40"]["rows"] > 16 // 2 > fetch["taxa_L10"]["rows"]


def test_cli_prints_the_report_keys(capsys, tmp_path):
    out = tmp_path / "plan.json"
    with pytest.raises(SystemExit):
        main(["--mode", "dp", "--mesh", "data=3", "--batch", "4", "--device", "cpu"])
    import linnaeus_tpu_torch.tools.shard_plan as sp

    orig = sp.build_plan
    sp.build_plan = lambda *a, **k: orig(*a, **dict(k, model=port_model(), num_classes=NC))
    try:
        main(["--mode", "tp", "--mesh", "data=2,model=2", "--batch", "8", "--img", str(IMG),
              "--device", "cpu", "--json", str(out)])
    finally:
        sp.build_plan = orig
    import json

    report = json.loads(out.read_text())
    for key in ("param_bytes_total", "param_bytes_per_device", "opt_ema_bytes_total",
                "opt_ema_bytes_per_device", "params_sharded", "params_total_leaves",
                "batch_per_device", "largest_replicated", "memory_analysis",
                "collectives_per_step"):
        assert key in report
    assert report["batch_per_device"] == 4 and not torch.distributed.is_initialized()
