"""The port's copy of ops_schedule/ against the TPU package's original.

Every case of tests/test_ops_schedule.py, and the cadences it leaves out,
runs on both packages' copies of ``OpsSchedule``, ``TrainingProgress`` and
``EarlyStopState`` built from each package's default config with the same
overrides; the observations (probabilities, triggers, picks drawn from the
schedule's seeded RNG, state dicts) must be equal, exactly: the copy does
the same float arithmetic. ``loss/gradnorm.py::should_update_gradnorm``
follows the copied rule.
"""

import pytest

import linnaeus_tpu.ops_schedule as jos
import linnaeus_tpu_torch.ops_schedule as tos
from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu_torch.configuration import get_default_config as t_default
from linnaeus_tpu_torch.loss.gradnorm import should_update_gradnorm

SIDES = {"jax": (j_default, jos), "torch": (t_default, tos)}


def make_schedule(side, total_steps=1000, **overrides):
    default, mod = SIDES[side]
    cfg = default()
    tp = mod.TrainingProgress(expected_total_steps=total_steps)
    for dotted, value in overrides.items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return mod.OpsSchedule(cfg, tp), tp, cfg


STEPS = (0, 1, 25, 50, 99, 100, 101, 150, 151, 250, 500, 999)


def meta_ramp(side):
    s, _, _ = make_schedule(side, **{"SCHEDULE.META_MASKING.END_STEPS": 100})
    return [s.get_meta_mask_prob(k) for k in STEPS]


def meta_fraction(side):
    s, _, _ = make_schedule(side, 200, **{"SCHEDULE.META_MASKING.END_STEPS": 0,
                                          "SCHEDULE.META_MASKING.END_FRACTION": 0.5})
    return [s.get_meta_mask_prob(k) for k in STEPS]


def null_disabled(side):
    s, _, _ = make_schedule(side)
    return [s.get_null_mask_prob(k) for k in STEPS]


def null_ramp(side):
    s, _, _ = make_schedule(side, **{"SCHEDULE.NULL_MASKING.ENABLED": True,
                                     "SCHEDULE.NULL_MASKING.END_STEPS": 100})
    return [s.get_null_mask_prob(k) for k in STEPS]


def mix_ramp_and_levels(side):
    s, _, _ = make_schedule(side, **{"SCHEDULE.MIX.LEVEL_SWITCH_STEPS": [100, 200]})
    return [(s.get_mixup_prob(k), s.get_mixup_group_level(k)) for k in STEPS]


def cutmix_draws(side):
    s, _, _ = make_schedule(side, **{"SCHEDULE.MIX.CUTMIX.ENABLED": True,
                                     "SCHEDULE.MIX.SWITCH_PROB": 0.5})
    return [s.should_use_cutmix() for _ in range(40)]


def gradnorm_cadence(side):
    s, _, cfg = make_schedule(side, **{"LOSS.GRAD_WEIGHTING.TASK.UPDATE_INTERVAL": 50,
                                       "LOSS.GRAD_WEIGHTING.TASK.GRADNORM_WARMUP_STEPS": 100})
    got = [s.should_update_gradnorm(k) for k in STEPS]
    assert got == [should_update_gradnorm(cfg.LOSS.GRAD_WEIGHTING.TASK, k) for k in STEPS]
    return got


def validation_epoch_trigger(side):
    s, tp, _ = make_schedule(side, **{"SCHEDULE.VALIDATION.INTERVAL_EPOCHS": 2,
                                      "SCHEDULE.VALIDATION.MASK_META_INTERVAL_EPOCHS": 3})
    out = []
    for epoch in range(6):
        tp.current_epoch = epoch
        out.append((s.should_validate(), s.should_validate_mask_meta(),
                    s.should_validate(at_epoch_boundary=False), s.is_final_epoch()))
    return out


def validation_step_trigger(side):
    s, tp, _ = make_schedule(side, **{"SCHEDULE.VALIDATION.INTERVAL_STEPS": 10})
    out = []
    for step in (0, 9, 10, 11, 20):
        tp.global_step = step
        out.append(s.should_validate(at_epoch_boundary=False))
    return out


def checkpoint_fraction_trigger(side):
    s, tp, _ = make_schedule(side, 100, **{"SCHEDULE.CHECKPOINT.INTERVAL_EPOCHS": 0,
                                           "SCHEDULE.CHECKPOINT.INTERVAL_FRACTION": 0.25})
    out = []
    for step in (24, 25, 26, 50, 75):
        tp.global_step = step
        out.append(s.should_save_checkpoint(at_epoch_boundary=False))
    return out


def partial_mask(side):
    s, _, _ = make_schedule(side, **{
        "SCHEDULE.META_MASKING.PARTIAL.ENABLED": True,
        "SCHEDULE.META_MASKING.PARTIAL.START_STEPS": 50,
        "SCHEDULE.META_MASKING.PARTIAL.END_FRACTION": 0.5,
        "SCHEDULE.META_MASKING.PARTIAL.WHITELIST": [["TEMPORAL"], ["SPATIAL"]],
        "SCHEDULE.META_MASKING.PARTIAL.WEIGHTS": [0.7, 0.3]})
    return ([(s.get_partial_mask_enabled(k), s.get_partial_meta_mask_prob(k)) for k in STEPS],
            [s.pick_partial_mask_combo() for _ in range(50)])


def partial_validation_and_exhaustive(side):
    s, tp, _ = make_schedule(side, **{
        "SCHEDULE.VALIDATION.PARTIAL_MASK_META.ENABLED": True,
        "SCHEDULE.VALIDATION.PARTIAL_MASK_META.INTERVAL_EPOCHS": 1,
        "SCHEDULE.VALIDATION.PARTIAL_MASK_META.WHITELIST": [["TEMPORAL"], ["SPATIAL"]],
        "SCHEDULE.VALIDATION.FINAL_EPOCH.EXHAUSTIVE_PARTIAL_META_VALIDATION": True,
        "SCHEDULE.VALIDATION.FINAL_EPOCH.EXHAUSTIVE_META_COMPONENTS": ["TEMPORAL", "SPATIAL"],
        "TRAIN.EPOCHS": 3})
    out = []
    for epoch in range(3):
        tp.current_epoch = epoch
        out.append((s.should_validate_partial_mask_meta(), s.get_partial_mask_meta_whitelist(),
                    s.should_run_exhaustive_final_validation(),
                    s.get_exhaustive_meta_components()))
    return out


def logging_cadences(side):
    s, _, _ = make_schedule(side, 1000, **{"SCHEDULE.METRICS.CONSOLE_INTERVAL": 0,
                                           "SCHEDULE.METRICS.CONSOLE_FRACTION": 0.1})
    return [(s.should_log_to_console(k), s.should_log_to_wandb(k), s.should_log_lr(k),
             s.should_log_pipeline_metrics(k)) for k in STEPS]


def early_stop_patience(side):
    s, tp, _ = make_schedule(side, **{"TRAIN.EARLY_STOP.ACTIVE": True,
                                      "TRAIN.EARLY_STOP.PATIENCE_STEPS": 100})
    es = SIDES[side][1].EarlyStopState()
    es.update(1.0, step=0)
    es.update(1.2, step=150)
    tp.global_step = 150
    return s.should_stop_early(early_stop_state=es), es.state_dict()


def early_stop_conditions(side):
    s, tp, _ = make_schedule(side, **{"TRAIN.EARLY_STOP.ACTIVE": True,
                                      "TRAIN.EARLY_STOP.PATIENCE_STEPS": 100,
                                      "TRAIN.EARLY_STOP.MAX_LOSS": 0.5,
                                      "TRAIN.EARLY_STOP.MIN_LR": 1e-6,
                                      "TRAIN.EARLY_STOP.MAX_GRAD_NORM": 10.0,
                                      "TRAIN.EARLY_STOP.MAX_STEPS": 400})
    mod = SIDES[side][1]
    es = mod.EarlyStopState(metric_name="val_chain_accuracy", higher_is_better=True)
    seen = [es.update(0.30, step=0), es.update(0.25, step=50)]
    tp.global_step = 50
    acc = mod.EarlyStopState(metric_name="val_acc", higher_is_better=True)
    acc.update(0.9, step=0)
    seen.append(s.should_stop_early(early_stop_state=acc))
    seen.append(es.update(0.40, step=120, min_delta=0.05))
    tp.global_step = 250
    seen += [es.update(0.35, step=250), s.should_stop_early(early_stop_state=es),
             s.should_stop_early(current_lr=1e-7), s.should_stop_early(grad_norm=11.0)]
    tp.global_step = 400
    seen.append(s.should_stop_early())
    loss = mod.EarlyStopState()
    loss.update(0.7, step=0)
    tp.global_step = 10
    seen.append(s.should_stop_early(early_stop_state=loss))
    return seen, es.state_dict()


def early_stop_roundtrip(side):
    mod = SIDES[side][1]
    es = mod.EarlyStopState(metric_name="val_acc1/taxa_L10", higher_is_better=True)
    es.update(0.5, step=10)
    es.update(0.4, step=30)
    clone = mod.EarlyStopState()
    clone.load_state_dict(es.state_dict())
    return clone.state_dict()


def training_progress_roundtrip(side):
    mod = SIDES[side][1]
    tp = mod.TrainingProgress(global_step=42, current_epoch=3, expected_total_steps=100)
    tp.queue_validation(mod.TrainingStage.VALIDATION_NORMAL)
    tp.queue_validation(mod.TrainingStage.VALIDATION_PARTIAL_MASK_META,
                        partial_combo=["TEMPORAL"])
    tp.partial_validation_indices["val"] = {"next_index": 2, "count": 16.0}
    tp.enter_stage(mod.TrainingStage.VALIDATION_MASK_META)
    tp.increment_step()
    state = tp.state_dict()
    tp2 = mod.TrainingProgress()
    tp2.load_state_dict(state)
    popped = [tp2.pop_validation(), tp2.pop_validation(), tp2.pop_validation()]
    tp2.end_epoch()
    tp2.start_epoch()
    return state, popped, tp2.state_dict(), tp2.fraction_complete, repr(tp2)


def rng_state_roundtrip(side):
    s, _, _ = make_schedule(side, **{
        "SCHEDULE.META_MASKING.PARTIAL.ENABLED": True,
        "SCHEDULE.META_MASKING.PARTIAL.WHITELIST": [["A"], ["B"], ["C"]]})
    import json

    state = json.loads(json.dumps(s.state_dict()))  # through a checkpoint sidecar
    seq1 = [tuple(s.pick_partial_mask_combo()) for _ in range(5)]
    s.load_state_dict(state)
    seq2 = [tuple(s.pick_partial_mask_combo()) for _ in range(5)]
    assert seq1 == seq2
    return seq1


CASES = [meta_ramp, meta_fraction, null_disabled, null_ramp, mix_ramp_and_levels, cutmix_draws,
         gradnorm_cadence, validation_epoch_trigger, validation_step_trigger,
         checkpoint_fraction_trigger, partial_mask, partial_validation_and_exhaustive,
         logging_cadences, early_stop_patience, early_stop_conditions, early_stop_roundtrip,
         training_progress_roundtrip, rng_state_roundtrip]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_copy_matches_the_original(case):
    assert case("torch") == case("jax")
