"""The harness finds a configuration, a traffic mix and a per-layer metric
by the names BENCHMARK.json gives them: new ones are new files and new
entries, and no file that is there is edited."""

from __future__ import annotations

import copy
import hashlib

import torch

from benchmark import common, run
from benchmark.tests.tiny import BENCH, SEED, copy_tree, tiny, write_json


def digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_config_mix_and_metric_are_picked_up_without_an_edit(tmp_path):
    root = copy_tree(tmp_path / "benchmark")
    before = digest(root)
    cfg = common.load_json(root / "configs" / "mFormerV1_sm.json")
    cfg["name"] = "mFormerV1_sm_dp10"
    cfg["config"]["MODEL"]["DROP_PATH_RATE"] = 0.1
    write_json(root / "configs" / "mFormerV1_sm_dp10.json", cfg)
    mix = common.load_json(root / "traffic" / "train384.json")
    mix["batch"] = 6
    write_json(root / "traffic" / "train_b6.json", mix)
    (root / "metrics" / "steps_seen.train.py").write_text(
        '"""The window\'s steps."""\n\n\ndef read(ctx):\n    return ctx["window"]["steps"]\n')
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "mFormerV1_sm_dp10", "source": "x", "reduced": [],
                             "file": "benchmark/configs/mFormerV1_sm_dp10.json", "why": "x"})
    bench["workloads"].append({"name": "new.cell", "config": "mFormerV1_sm_dp10",
                               "traffic": "train_b6", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_img_per_s", "workloads": ["new.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("new.cell")

    def tiny_keeping_the_batch(doc, traffic):
        batch = traffic["batch"]
        tiny(doc, traffic)
        traffic["batch"] = batch

    seen = {}

    class Probe:
        """The traffic's driver, its geometry recorded."""

        def __init__(self, doc, traffic, seed, device):
            from benchmark.drivers.train import TrainDriver

            self.inner = TrainDriver(doc, traffic, seed, device)
            seen.update(drop_path=self.inner.spec["drop_path_rate"], batch=self.inner.batch)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    import benchmark.drivers.train as train_driver

    real = train_driver.DRIVER
    train_driver.DRIVER = Probe
    try:
        result = run.run_cell(bench, "new.cell", SEED, 0.3, False, torch.device("cpu"),
                              root=root, adjust=tiny_keeping_the_batch)
    finally:
        train_driver.DRIVER = real
    assert result["correct"] is True
    assert seen == {"drop_path": 0.1, "batch": 6}
    read = common.metric_reader("steps_seen.train", root)
    assert read({"window": {"steps": 7}}) == 7
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_metric_without_a_reader_is_left_out():
    assert common.metric_reader("no_such_metric.train") is None
