"""CLI: ``python -m linnaeus_tpu_torch.train.main --cfg exp.yaml --opts K V ...``

Port of linnaeus_tpu/train/main.py (reference parity: linnaeus/main.py:
356-423 parse_option + 2550-2643 bootstrap). It trains on
the CUDA device unless ``--device`` names another (``--device cpu`` for a
machine without a card); without a card and without ``--device`` it raises.
``--throughput`` runs the synthetic throughput test of the config's model
(evaluation/throughput.py) instead of training. ``build_trainer`` is
everything ``main`` does before ``Trainer.train``. ENV.COMPILE_CACHE
configures the TPU package's XLA cache and has nothing to do here.

More than one rank: one process per card, started by
``torch.distributed.run``, which sets the environment the process group
starts from (parallel/mesh.py::initialize_multi_host: ``nccl`` on the
cards, ``gloo`` under ``--device cpu``), before the first touch of a card;
each rank logs to ``logs/main_p<rank>.log`` and rank 0 alone to the
console, the metrics files, wandb and the checkpoints (train/loop.py).

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m linnaeus_tpu_torch.train.main --cfg exp.yaml

    python -m linnaeus_tpu_torch.train.main --cfg exp.yaml
    python -m linnaeus_tpu_torch.train.main --cfg exp.yaml --device cpu
    python -m linnaeus_tpu_torch.train.main --cfg exp.yaml --opts TRAIN.EPOCHS 3
    python -m linnaeus_tpu_torch.train.main --cfg exp.yaml --throughput
"""

from __future__ import annotations

import argparse

from linnaeus_tpu_torch.configuration import build_config, save_config
from linnaeus_tpu_torch.utils.logging import create_h5data_logger, create_logger


def parse_option(argv=None):
    parser = argparse.ArgumentParser("linnaeus_tpu_torch training")
    parser.add_argument("--cfg", type=str, default=None, help="experiment yaml")
    parser.add_argument(
        "--opts", nargs="*", default=None,
        help="config overrides: KEY VALUE [KEY VALUE ...]",
    )
    parser.add_argument(
        "--skip-validation", action="store_true",
        help="skip pending-validation replay and scheduled validations",
    )
    parser.add_argument(
        "--throughput", action="store_true",
        help="run the synthetic throughput test instead of training",
    )
    parser.add_argument(
        "--backend", default=None, choices=("nccl", "gloo"),
        help="the process group's backend under torch.distributed.run (default: nccl on "
             "the card, gloo on the CPU; gloo on the card puts several ranks on one card)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help='where to train: "cuda" (default; raises without a card), "cuda:N" or "cpu"',
    )
    args = parser.parse_args(argv)
    config = build_config(args.cfg, opts=args.opts)
    config.freeze()
    return args, config


def setup(argv=None):
    """Parse the options, resolve the device, create the output
    directories and the loggers, and save the merged config; returns
    (args, config, device)."""
    args, config = parse_option(argv)
    from linnaeus_tpu_torch.parallel.mesh import initialize_multi_host
    from linnaeus_tpu_torch.parallel.ops import get_rank_safely
    from linnaeus_tpu_torch.utils.device import resolve_device

    initialize_multi_host(config, args.device, args.backend)
    rank = get_rank_safely()
    device = resolve_device(None if args.device == "cuda" else args.device)
    from linnaeus_tpu_torch.configuration.utils import setup_output_dirs

    setup_output_dirs(config)
    log_dir = config.ENV.OUTPUT.DIRS.LOGS
    # DEBUG.VERBOSE_DEBUG: force both loggers to DEBUG so the per-flag
    # debug sites (check_debug_flag) become visible without touching levels
    level_main = config.EXPERIMENT.LOG_LEVEL_MAIN
    level_h5 = config.EXPERIMENT.LOG_LEVEL_H5DATA
    if bool(config.DEBUG.get("VERBOSE_DEBUG", False)):
        level_main = level_h5 = "DEBUG"
    create_logger(log_dir, level=level_main, process_index=rank)
    create_h5data_logger(log_dir, level=level_h5, process_index=rank)
    if config.EXPERIMENT.CODE_VERSION:
        # reference parity: surface the experiment's code version at startup
        # (main.py:458-459)
        from linnaeus_tpu_torch.utils.logging import get_main_logger

        get_main_logger().critical(f"CODE VERSION: {config.EXPERIMENT.CODE_VERSION}")
    if rank == 0:
        save_config(config, f"{config.ENV.OUTPUT.DIRS.CONFIGS}/merged_config.yaml")
    return args, config, device


def build_trainer(argv=None):
    """The Trainer ``main`` trains, built as ``main`` builds it (pretrained
    weights loaded, AutoBatch run), not yet trained."""
    from linnaeus_tpu_torch.train.loop import Trainer

    args, config, device = setup(argv)
    return Trainer(config, skip_validation=args.skip_validation, device=device)


def main(argv=None):
    """Train as the config says; returns the Trainer after training, its
    loaders stopped and its checkpoints written. With ``--throughput``,
    returns the throughput test's results instead."""
    args, config, device = setup(argv)
    if args.throughput:
        from linnaeus_tpu_torch.evaluation.throughput import throughput_test

        return throughput_test(config, device=device)

    from linnaeus_tpu_torch.train.loop import Trainer

    trainer = Trainer(config, skip_validation=args.skip_validation, device=device)
    try:
        trainer.train()
    finally:
        # any in-flight async checkpoint flush must finalize before exit
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
