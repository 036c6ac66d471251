"""The port's copy of utils/remote_sync.py and data/ensure_ops_schedule.py.

The four cases of tests/test_remote_sync.py against the copy, under the same
mocked b2sdk (the port's Trainer in place of the TPU package's); the copy
against the original (the same source but for the logger and ``hf://``,
which the port refuses by name); a ``b2://`` pretrained file fetched through
a mocked bucket into the cache and loaded; ``ensure_ops_schedule`` as the
TPU package's.
"""

from __future__ import annotations

import inspect
import os
import sys
import time
import types
from unittest.mock import MagicMock

import pytest
import torch

import linnaeus_tpu.utils.remote_sync as j_rs
import linnaeus_tpu_torch.utils.remote_sync as rs
from linnaeus_tpu.data import ensure_ops_schedule as j_ensure_ops_schedule
from linnaeus_tpu_torch.configuration import get_default_config
from linnaeus_tpu_torch.data import ensure_ops_schedule


def _mock_b2(monkeypatch, bucket=None):
    bucket = bucket or MagicMock()
    api = MagicMock()
    api.get_bucket_by_name.return_value = bucket
    v2 = types.ModuleType("b2sdk.v2")
    v2.B2Api = MagicMock(return_value=api)
    v2.InMemoryAccountInfo = MagicMock()
    pkg = types.ModuleType("b2sdk")
    pkg.v2 = v2
    monkeypatch.setitem(sys.modules, "b2sdk", pkg)
    monkeypatch.setitem(sys.modules, "b2sdk.v2", v2)
    return api, bucket


def _bucket_cfg(enabled=True):
    cfg = get_default_config()
    cfg.ENV.OUTPUT.BUCKET.ENABLED = enabled
    cfg.ENV.OUTPUT.BUCKET.BUCKET = "mybucket"
    cfg.ENV.OUTPUT.BUCKET.APP_KEY_ID = "k"
    cfg.ENV.OUTPUT.BUCKET.APP_KEY = "s"
    return cfg


def test_sync_to_bucket_uploads_all_files(tmp_path, monkeypatch):
    api, bucket = _mock_b2(monkeypatch)
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.txt").write_text("a")
    (tmp_path / "sub" / "b.txt").write_text("b")
    assert rs.sync_to_bucket(_bucket_cfg(), str(tmp_path)) is True
    api.authorize_account.assert_called_once_with("production", "k", "s")
    assert {c.args[1] for c in bucket.upload_local_file.call_args_list} == {"a.txt", "sub/b.txt"}


def test_sync_to_bucket_disabled_is_noop_and_needs_b2sdk(tmp_path, monkeypatch):
    _, bucket = _mock_b2(monkeypatch)
    assert rs.sync_to_bucket(_bucket_cfg(enabled=False), str(tmp_path)) is False
    bucket.upload_local_file.assert_not_called()
    monkeypatch.setitem(sys.modules, "b2sdk.v2", None)  # not installed: a logged no-op
    assert rs.sync_to_bucket(_bucket_cfg(), str(tmp_path)) is False


def test_trainer_sync_outputs_gated(monkeypatch, tmp_path):
    """Trainer._sync_outputs hands the experiment's base directory to
    sync_to_bucket when enabled, on rank 0 only."""
    from linnaeus_tpu_torch.train.loop import Trainer

    cfg = get_default_config()
    cfg.ENV.OUTPUT.BUCKET.ENABLED = True
    cfg.ENV.OUTPUT.DIRS.EXP_BASE = str(tmp_path)
    calls = []
    monkeypatch.setattr(rs, "sync_to_bucket", lambda c, d: calls.append(d) or True)
    dummy = object.__new__(Trainer)  # no full Trainer build needed
    dummy.config, dummy.is_main = cfg, True
    Trainer._sync_outputs(dummy)
    assert calls == [str(tmp_path)]
    dummy.is_main = False
    Trainer._sync_outputs(dummy)
    cfg.ENV.OUTPUT.BUCKET.ENABLED = False
    dummy.is_main = True
    Trainer._sync_outputs(dummy)
    assert calls == [str(tmp_path)]  # still one call


def test_sync_to_bucket_incremental(tmp_path, monkeypatch):
    """A second sync of an unchanged tree uploads nothing; a touched file
    uploads again."""
    uploads = []
    bucket = MagicMock()
    bucket.upload_local_file.side_effect = lambda path, rel: uploads.append(rel)
    _mock_b2(monkeypatch, bucket)
    d = tmp_path / "exp"
    d.mkdir()
    (d / "a.txt").write_text("1")
    (d / "b.txt").write_text("2")
    rs._last_sync_mtime.pop(str(d), None)
    assert rs.sync_to_bucket(_bucket_cfg(), str(d)) is True
    assert sorted(uploads) == ["a.txt", "b.txt"]
    uploads.clear()
    assert rs.sync_to_bucket(_bucket_cfg(), str(d)) is True
    assert uploads == []
    time.sleep(0.01)
    (d / "a.txt").write_text("3")
    os.utime(d / "a.txt")
    assert rs.sync_to_bucket(_bucket_cfg(), str(d)) is True
    assert uploads == ["a.txt"]


def _body(fn) -> str:
    return inspect.getsource(fn).split('"""')[-1]


def test_the_copy_is_the_original(tmp_path):
    """The same code but for ``hf://``, which raises by name; local paths
    and directory copies behave alike."""
    for name in ("sync_to_bucket", "copy_checkpoint_local"):
        assert _body(getattr(rs, name)) == _body(getattr(j_rs, name)), name
    ours, theirs = _body(rs.resolve_checkpoint_path), _body(j_rs.resolve_checkpoint_path)
    assert ours[ours.index('if path_or_uri.startswith("b2://")'):] == \
        theirs[theirs.index('if path_or_uri.startswith("b2://")'):]
    with pytest.raises(NotImplementedError, match="hf://"):
        rs.resolve_checkpoint_path("hf://org/repo/w.pth")
    assert rs.resolve_checkpoint_path("w.pth") == j_rs.resolve_checkpoint_path("w.pth") == "w.pth"
    src = tmp_path / "ckpt"
    src.mkdir()
    (src / "state.pt").write_bytes(b"x")
    a = rs.copy_checkpoint_local(str(src), str(tmp_path / "a"))
    b = j_rs.copy_checkpoint_local(str(src), str(tmp_path / "b"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == ["state.pt"]
    assert _body(ensure_ops_schedule) == _body(j_ensure_ops_schedule)


def test_b2_pretrained_file_is_fetched_into_the_cache_and_loaded(tmp_path, monkeypatch):
    """MODEL.PRETRAINED 'b2://bucket/key': the file comes down once through
    the bucket (B2_APP_KEY_ID / B2_APP_KEY), into ~/.cache/linnaeus_tpu,
    and loads as a local file does."""
    from linnaeus_tpu_torch.utils import pretrained as tpre

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("B2_APP_KEY_ID", "id")
    monkeypatch.setenv("B2_APP_KEY", "key")
    weights = {"w": torch.arange(6.0).reshape(2, 3)}
    bucket = MagicMock()

    def download(key):
        out = MagicMock()
        out.save_to.side_effect = lambda path: torch.save({"state_dict": weights}, path)
        return out

    bucket.download_file_by_name.side_effect = download
    api, _ = _mock_b2(monkeypatch, bucket)
    for _ in range(2):
        got = tpre.load_torch_state_dict("b2://bucket/dir/w.pth")
        assert torch.equal(got["w"], weights["w"])
    bucket.download_file_by_name.assert_called_once_with("dir/w.pth")
    api.authorize_account.assert_called_once_with("production", "id", "key")
    assert os.path.isfile(tmp_path / ".cache" / "linnaeus_tpu" / "bucket" / "dir" / "w.pth")


def test_ensure_ops_schedule_binds_late():
    loader = types.SimpleNamespace()
    ensure_ops_schedule(loader, None)
    assert not hasattr(loader, "ops_schedule")
    ensure_ops_schedule(loader, "schedule")
    ensure_ops_schedule(loader, "other")
    assert loader.ops_schedule == "schedule"
