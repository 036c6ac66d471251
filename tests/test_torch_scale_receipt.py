"""The port's scale receipt: its processor and sampler phases, each in its
own subprocess, on a few thousand rows of ``.npz`` labels, and both phases
in-process against the TPU package's on the same rows as HDF5."""

from __future__ import annotations

import json

import linnaeus_tpu.tools.scale_receipt as j_sr
import linnaeus_tpu_torch.tools.scale_receipt as sr

ROWS = 4096


def test_processor_and_sampler_phases_in_subprocesses(tmp_path, capsys):
    sr.main(["--rows", str(ROWS), "--dir", str(tmp_path), "--out", str(tmp_path / "r.json")])
    (row,) = json.loads((tmp_path / "r.json").read_text())["sizes"]
    assert row["rows"] == ROWS and "loader" not in row
    proc, samp = row["processor"], row["sampler"]
    assert proc["n_train"] + proc["n_val"] == ROWS
    assert proc["n_classes"] == {"taxa_L10": 1000, "taxa_L20": 400, "taxa_L30": 100,
                                 "taxa_L40": 30}
    assert proc["peak_rss_mb"] > 0 and samp["peak_rss_mb"] > 0
    assert samp["batches"] > 0 and samp["batches_epoch1"] == samp["batches"]
    assert not list(tmp_path.glob("labels_*"))  # deleted without --keep
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["scale_receipt"]


def test_phases_match_the_tpu_package_on_the_same_rows(tmp_path):
    npz, h5 = str(tmp_path / "l.npz"), str(tmp_path / "l.h5")
    sr.generate_labels(npz, ROWS)
    j_sr.generate_labels(h5, ROWS)
    for ours, theirs, keys in (
        (sr.phase_processor(npz, 32), j_sr.phase_processor(h5, 32),
         ("n_train", "n_val", "n_classes")),
        (sr.phase_sampler(npz, 32, 128), j_sr.phase_sampler(h5, 32, 128),
         ("batches", "batches_epoch1")),
    ):
        assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
