"""The port's AutoBatch against the TPU package's.

(a) The search: over a seeded table of needs (bytes a sample plus fixed
bytes), budgets, bounds and ``multiple_of``, with a failure above a seeded
batch in some rows (a failed compile in JAX, ``torch.cuda.OutOfMemoryError``
in the port), the port's ``auto_find_batch_size`` chooses the batch JAX's
chooses, the latter fed the fake memory analysis of tests/test_autobatch.py.

(b) The Trainer, on the CPU, with the search patched to try two batches by
real steps and return B (the card's memory and the peak probe patched too:
there is no card here): the same BATCH_SIZE / BATCH_SIZE_VAL, BASE_LR,
TOTAL_STEPS and loader lengths as the TPU package's Trainer patched alike;
each train trial ends with one GradNorm update at its batch, and the train
search keeps to even batches (the 'mixed-pairs' sampler's); its state after
the search equals a fresh Trainer's bit for bit (the trials are undone); and
its first epoch's losses equal those of a Trainer with ``BATCH_SIZE = B``
set by hand. A run that resumes from a checkpoint does not search again: it
takes the batches and the base LR the checkpoint records (the configured
ones when it records none). Without a card AutoBatch raises by name.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import linnaeus_tpu.train.autobatch as jab
import linnaeus_tpu_torch.train.build as tbuild
import linnaeus_tpu_torch.train.loop as tloop
import linnaeus_tpu_torch.utils.hpc as thpc
from linnaeus_tpu.train.loop import Trainer as JTrainer
from linnaeus_tpu_torch.train.autobatch import auto_find_batch_size
from linnaeus_tpu_torch.train.loop import Trainer
from linnaeus_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_trainer import deterministic, port_config, step_rows, time_limit
from tests.test_trainer_e2e import data_dir, make_config  # noqa: F401  (data_dir: a fixture)


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a == b


def search_cases(n: int = 16):
    rng = np.random.default_rng(10)
    for i in range(n):
        lo = int(rng.integers(1, 24))
        yield dict(per_sample=int(rng.integers(1, 60)), fixed=int(rng.integers(0, 2000)),
                   total=int(rng.integers(500, 20000)), fraction=float(rng.choice([0.5, 0.8, 0.9])),
                   lo=lo, hi=lo + int(rng.integers(0, 600)),
                   multiple_of=int(rng.choice([1, 2, 4, 8])),
                   fails_above=int(rng.integers(8, 400)) if i % 3 == 0 else None)


@pytest.mark.parametrize("case", list(search_cases()), ids=lambda c: str(sorted(c.items())))
def test_search_chooses_what_jax_chooses(case):
    def need(bs):
        return case["per_sample"] * bs + case["fixed"]

    def jax_compile_step(bs):
        if case["fails_above"] is not None and bs > case["fails_above"]:
            raise RuntimeError("RESOURCE_EXHAUSTED: compile failed")
        mem = types.SimpleNamespace(
            temp_size_in_bytes=case["per_sample"] * bs, argument_size_in_bytes=case["fixed"],
            output_size_in_bytes=0, generated_code_size_in_bytes=0, alias_size_in_bytes=0)
        return types.SimpleNamespace(memory_analysis=lambda: mem)

    def measure(bs):
        if case["fails_above"] is not None and bs > case["fails_above"]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return need(bs)

    bounds = dict(target_memory_fraction=case["fraction"], min_batch_size=case["lo"],
                  max_batch_size=case["hi"], multiple_of=case["multiple_of"])
    want = jab.auto_find_batch_size(jax_compile_step, hbm_bytes=case["total"], **bounds)
    trials = {}
    got = auto_find_batch_size(measure, total_bytes=case["total"], trials=trials, **bounds)
    assert got == want and got % case["multiple_of"] == 0
    # every tried batch above the found one failed or exceeded the budget
    budget = int(case["total"] * case["fraction"])
    for bs, used in trials.items():
        if bs > got:
            assert used is None or used > budget


@pytest.fixture(autouse=True)
def fresh_registry():
    thpc._registry = None
    yield
    thpc._registry = None


B0, B, B_VAL = 8, 16, 4


def config(data_dir, out, train: bool = True, val: bool = True):  # noqa: F811
    cfg = deterministic(make_config(data_dir, out, epochs=1))
    cfg.DATA.AUTOBATCH.ENABLED = train
    cfg.DATA.AUTOBATCH.ENABLED_VAL = val
    return cfg


def patch_port(monkeypatch, found: dict, tried: list, gradnorm: list | None = None,
               multiples: list | None = None):
    """The card's memory and the peak probe (no card on the CPU), and a
    search that runs two trials, then returns ``found[fraction]``; the batch
    of every GradNorm update is appended to ``gradnorm``, each search's
    ``multiple_of`` to ``multiples``."""
    monkeypatch.setattr(tloop, "device_memory_bytes", lambda device: 10**12)
    make_gradnorm_step = tbuild.make_gradnorm_step

    def counted(update, train_step):
        step = make_gradnorm_step(update, train_step)

        def gradnorm_step(state, batch, scalars):
            if gradnorm is not None:
                gradnorm.append(int(batch["images"].shape[0]))
            return step(state, batch, scalars)

        return gradnorm_step

    monkeypatch.setattr(tbuild, "make_gradnorm_step", counted)

    def measure_peak_bytes(run_trial, bs, device):
        run_trial(bs)
        return 0

    monkeypatch.setattr(tloop, "measure_peak_bytes", measure_peak_bytes)

    def search(measure, target_memory_fraction, min_batch_size, max_batch_size, total_bytes,
               multiple_of, trials):
        if multiples is not None:
            multiples.append(multiple_of)
        for bs in (B0, B):
            trials[bs] = measure(bs)
            tried.append(bs)
        return found[target_memory_fraction]

    monkeypatch.setattr(tloop, "auto_find_batch_size", search)


@time_limit(240)
def test_trainer_after_autobatch_matches_jax_and_a_hand_set_batch(data_dir, tmp_path,  # noqa: F811
                                                                  monkeypatch):
    fractions = {"train": 0.8, "val": 0.7}
    found = {fractions["train"]: B, fractions["val"]: B_VAL}

    jcfg = config(data_dir, tmp_path / "jax")
    jcfg.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION = fractions["train"]
    jcfg.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION_VAL = fractions["val"]
    monkeypatch.setattr(jab, "auto_find_batch_size",
                        lambda compile_step, target_memory_fraction, **kw:
                        found[target_memory_fraction])
    jtrainer = JTrainer(jcfg)
    jtrainer.train_loader.close()
    jtrainer.val_loader.close()

    tried, gradnorm, multiples = [], [], []
    patch_port(monkeypatch, found, tried, gradnorm, multiples)
    pcfg = port_config(config(data_dir, tmp_path / "port"))
    pcfg.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION = fractions["train"]
    pcfg.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION_VAL = fractions["val"]
    trainer = Trainer(pcfg, device="cpu")
    assert tried == [B0, B, B0, B] and gradnorm == [B0, B]
    # the train sampler ('mixed-pairs') takes even batches; validation's any
    assert trainer.train_loader.sampler.mode == "mixed-pairs" and multiples == [2, 1]
    for key in ("DATA.BATCH_SIZE", "DATA.BATCH_SIZE_VAL", "LR_SCHEDULER.BASE_LR",
                "LR_SCHEDULER.TOTAL_STEPS"):
        a, b = jtrainer.config, trainer.config
        for part in key.split("."):
            a, b = a[part], b[part]
        assert a == b, key
    assert trainer.config.DATA.BATCH_SIZE == B and trainer.config.DATA.BATCH_SIZE_VAL == B_VAL
    assert (len(trainer.train_loader), len(trainer.val_loader)) == (
        len(jtrainer.train_loader), len(jtrainer.val_loader))
    assert trainer.steps_per_epoch == jtrainer.steps_per_epoch
    assert trainer.autobatch["train"]["base_lr_after"] == (
        B / B0 * trainer.autobatch["train"]["base_lr_before"])

    hand_cfg = port_config(config(data_dir, tmp_path / "hand", train=False, val=False))
    hand_cfg.DATA.BATCH_SIZE, hand_cfg.DATA.BATCH_SIZE_VAL = B, B_VAL
    hand = Trainer(hand_cfg, device="cpu")
    assert hand.config.LR_SCHEDULER.BASE_LR == trainer.config.LR_SCHEDULER.BASE_LR
    # the trials ran real steps; the state they left is undone, and the
    # optimizer is rebuilt for the new batch
    assert same_bits(ckpt.snapshot_state(trainer.state), ckpt.snapshot_state(hand.state))
    for t in (trainer, hand):
        t.train()
        t.close()
    got = step_rows(trainer.config.ENV.OUTPUT.DIRS.LOGS)
    want = step_rows(hand.config.ENV.OUTPUT.DIRS.LOGS)
    assert sorted(got) == sorted(want) == list(range(1, trainer.steps_per_epoch + 1))
    assert [got[s]["train/loss"] for s in sorted(got)] == [want[s]["train/loss"] for s in sorted(want)]
    assert trainer.metrics.phase_summary("val") == hand.metrics.phase_summary("val")


def heads_group(cfg):
    """The parameter groups of configs/experiments/generic_mformer_example.yaml
    (the heads at 10x: one optimizer a group)."""
    cfg.OPTIMIZER.PARAMETER_GROUPS.ENABLED = True
    cfg.OPTIMIZER.PARAMETER_GROUPS.merge_from_other_cfg(
        {"HEADS": {"FILTER": {"TYPE": "name", "PATTERNS": ["head_"]}, "LR_MULTIPLIER": 10.0}})
    return cfg


@time_limit(120)
@pytest.mark.parametrize("groups", [False, True], ids=["one_group", "heads_group"])
def test_a_search_that_keeps_the_batch_undoes_its_trials(data_dir, tmp_path,  # noqa: F811
                                                         monkeypatch, groups):
    tried, gradnorm = [], []
    patch_port(monkeypatch, {0.8: B0}, tried, gradnorm)
    cfgs = [port_config(config(data_dir, tmp_path / "kept", val=False)),
            port_config(config(data_dir, tmp_path / "fresh", train=False, val=False))]
    if groups:
        cfgs = [heads_group(c) for c in cfgs]
    trainer = Trainer(cfgs[0], device="cpu")
    fresh = Trainer(cfgs[1], device="cpu")
    assert tried == [B0, B] and trainer.config.DATA.BATCH_SIZE == B0
    assert gradnorm == [B0, B]  # the update's peak is part of each train trial
    assert trainer.autobatch["train"]["trials"] == {B0: 0, B: 0}
    assert same_bits(ckpt.snapshot_state(trainer.state), ckpt.snapshot_state(fresh.state))
    assert all(p.grad is None for p in trainer.model.parameters())
    trainer.close()
    fresh.close()


@time_limit(240)
@pytest.mark.parametrize("recorded", [True, False], ids=["recorded", "unrecorded"])
def test_a_resumed_run_keeps_the_batch_it_trained_with(data_dir, tmp_path,  # noqa: F811
                                                       monkeypatch, recorded):
    fractions = {"train": 0.8, "val": 0.7}

    def autobatch_config(epochs):
        cfg = port_config(config(data_dir, tmp_path / "out"))
        cfg.TRAIN.EPOCHS = epochs
        cfg.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION = fractions["train"]
        cfg.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION_VAL = fractions["val"]
        return cfg

    tried = []
    patch_port(monkeypatch, {fractions["train"]: B, fractions["val"]: B_VAL}, tried)
    first = Trainer(autobatch_config(1), device="cpu")
    first.train()
    first.close()
    assert tried == [B0, B, B0, B] and first.config.DATA.BATCH_SIZE == B
    path = ckpt.auto_resume_helper(first.ckpt_dir)
    sidecar = os.path.join(path, ckpt.SIDECAR_NAME)
    with open(sidecar) as f:
        record = json.load(f)
    assert record["batch"] == {"BATCH_SIZE": B, "BATCH_SIZE_VAL": B_VAL,
                               "BASE_LR": first.config.LR_SCHEDULER.BASE_LR}
    if not recorded:  # a checkpoint written before the batch was recorded
        del record["batch"]
        with open(sidecar, "w") as f:
            json.dump(record, f)

    # a new process: its search would choose other batches, and must not run
    tried.clear()
    patch_port(monkeypatch, {fractions["train"]: 2 * B, fractions["val"]: 2 * B_VAL}, tried)
    second = Trainer(autobatch_config(2), device="cpu")
    assert tried == []
    if recorded:
        want = (B, B_VAL, first.config.LR_SCHEDULER.BASE_LR)
        assert second.autobatch["train"]["resumed_from"] == path
        assert len(second.val_loader) == len(first.val_loader)
    else:
        want = (B0, B0, first.autobatch["train"]["base_lr_before"])
        assert second.autobatch == {}
    assert (second.config.DATA.BATCH_SIZE, second.config.DATA.BATCH_SIZE_VAL,
            second.config.LR_SCHEDULER.BASE_LR) == want
    assert len(second.train_loader) == second.steps_per_epoch
    assert second.config.LR_SCHEDULER.TOTAL_STEPS == 2 * second.steps_per_epoch
    assert second.progress.expected_total_steps == 2 * second.steps_per_epoch
    if recorded:
        assert second.steps_per_epoch == first.steps_per_epoch
        second.train()
        assert second.resumed_from == path
        assert second.epoch_timings[1]["first_step"] == first.progress.global_step + 1
        assert second.progress.global_step == 2 * first.steps_per_epoch
        rows = step_rows(second.config.ENV.OUTPUT.DIRS.LOGS)
        assert all(np.isfinite(r["train/loss"]) for r in rows.values())
    second.close()


@time_limit(60)
def test_autobatch_without_a_card_raises_by_name(data_dir, tmp_path):  # noqa: F811
    for train, val in ((True, False), (False, True)):
        with pytest.raises(NotImplementedError, match=r"DATA\.AUTOBATCH.*CUDA memory"):
            Trainer(port_config(config(data_dir, tmp_path / "out", train, val)), device="cpu")


def with_fractions(cfg):
    """Warm-up and metadata masking given as fractions of the run (as in
    configs/experiments/generic_mformer_example.yaml), not as steps, over
    four epochs."""
    cfg.TRAIN.EPOCHS = 4
    cfg.LR_SCHEDULER.WARMUP_STEPS = 0
    cfg.LR_SCHEDULER.WARMUP_FRACTION = 0.25
    cfg.SCHEDULE.META_MASKING.END_STEPS = 0
    cfg.SCHEDULE.META_MASKING.END_FRACTION = 0.5
    return cfg


FRACTION_STEPS = ("LR_SCHEDULER.WARMUP_STEPS", "SCHEDULE.META_MASKING.END_STEPS",
                  "LR_SCHEDULER.TOTAL_STEPS", "LR_SCHEDULER.BASE_LR")


def read(cfg, dotted):
    for part in dotted.split("."):
        cfg = cfg[part]
    return cfg


@time_limit(240)
def test_autobatch_resolves_the_fractions_for_the_batch_it_finds(data_dir, tmp_path,  # noqa: F811
                                                               monkeypatch):
    """F6: after AutoBatch changes the batch, every step count given as a
    fraction is resolved again for the new batch's run, so the Trainer
    equals the JAX Trainer configured with the found batch by hand (the
    warm-up, the masking end, TOTAL_STEPS, BASE_LR) and trains the losses
    of the port's own hand-set Trainer bit for bit. The port departs here
    from the JAX package's AutoBatch on purpose, as it does for F7 (ROADMAP
    Queue 3): JAX keeps the configured batch's resolved steps."""
    jcfg = with_fractions(config(data_dir, tmp_path / "jax", train=False, val=False))
    jcfg.DATA.BATCH_SIZE = B
    jtrainer = JTrainer(jcfg)
    jtrainer.train_loader.close()
    jtrainer.val_loader.close()

    tried = []
    patch_port(monkeypatch, {0.8: B}, tried)
    pcfg = port_config(with_fractions(config(data_dir, tmp_path / "port", val=False)))
    pcfg.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION = 0.8
    trainer = Trainer(pcfg, device="cpu")
    assert tried == [B0, B] and trainer.config.DATA.BATCH_SIZE == B
    configured = Trainer(port_config(with_fractions(
        config(data_dir, tmp_path / "configured", train=False, val=False))), device="cpu")
    configured.close()
    for key in FRACTION_STEPS:
        assert read(trainer.config, key) == read(jtrainer.config, key), key
    for key in FRACTION_STEPS[:3]:  # the configured batch's counts are twice as many
        assert read(configured.config, key) == 2 * read(trainer.config, key), key

    hand_cfg = port_config(with_fractions(config(data_dir, tmp_path / "hand", train=False,
                                                 val=False)))
    hand_cfg.DATA.BATCH_SIZE = B
    hand = Trainer(hand_cfg, device="cpu")
    for key in FRACTION_STEPS:
        assert read(hand.config, key) == read(trainer.config, key), key
    assert same_bits(ckpt.snapshot_state(trainer.state), ckpt.snapshot_state(hand.state))
    for t in (trainer, hand):
        t.train()
        t.close()
    got = step_rows(trainer.config.ENV.OUTPUT.DIRS.LOGS)
    want = step_rows(hand.config.ENV.OUTPUT.DIRS.LOGS)
    assert sorted(got) == sorted(want) == list(range(1, 4 * trainer.steps_per_epoch + 1))
    for key in ("train/loss", "lr"):
        assert [got[s].get(key) for s in sorted(got)] == [want[s].get(key) for s in sorted(want)]
