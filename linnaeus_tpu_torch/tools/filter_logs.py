"""Filter training log files by level/pattern/component.

Reference parity: linnaeus/tools/filter_logs.py — grep-style filtering of
the per-process log files with level and component selectors.

A copy of linnaeus_tpu/tools/filter_logs.py, which imports no
JAX: the port imports nothing of the TPU package
(tests/test_torch_data_tools.py holds the two together).
"""

from __future__ import annotations

import argparse
import re
import sys

LEVELS = ["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"]


def filter_lines(
    lines,
    min_level: str = "DEBUG",
    pattern: str | None = None,
    component: str | None = None,
):
    min_idx = LEVELS.index(min_level.upper())
    regex = re.compile(pattern) if pattern else None
    for line in lines:
        level_idx = next(
            (i for i, lv in enumerate(LEVELS) if f" {lv}: " in line), None
        )
        if level_idx is not None and level_idx < min_idx:
            continue
        if regex and not regex.search(line):
            continue
        if component and f"({component}" not in line:
            continue
        yield line.rstrip("\n")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("filter_logs")
    parser.add_argument("path", help="log file ('-' for stdin)")
    parser.add_argument("--level", default="INFO")
    parser.add_argument("--pattern", default=None)
    parser.add_argument("--component", default=None,
                        help="source filename filter, e.g. loop.py")
    args = parser.parse_args(argv)
    stream = sys.stdin if args.path == "-" else open(args.path)
    try:
        for line in filter_lines(stream, args.level, args.pattern, args.component):
            print(line)
    finally:
        if stream is not sys.stdin:
            stream.close()


if __name__ == "__main__":
    main()
