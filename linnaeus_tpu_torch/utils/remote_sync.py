"""Remote artifact sync: Backblaze B2 output sync + checkpoint resolution.

Copy of linnaeus_tpu/utils/remote_sync.py (reference parity:
utils/backblaze.py:10-54 (output-dir sync) and
utils/checkpoint_utils.py:14-104 (remote checkpoint download/cache)).
The b2sdk dependency is optional; everything degrades to a logged no-op.
One departure: ``hf://`` raises by name, where the TPU package downloads
through ``huggingface_hub``; the port fetches nothing from a model hub.
"""

from __future__ import annotations

import os
import shutil

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()


_last_sync_mtime: dict[str, float] = {}


def sync_to_bucket(config, local_dir: str) -> bool:
    """Sync an output directory to the configured B2 bucket (if enabled).

    Incremental within a process: only files modified since the previous
    successful sync of the same directory are uploaded — with
    SYNC_ON_CHECKPOINT a multi-GB checkpoint tree would otherwise re-upload
    in full at every save and again at shutdown.
    """
    bucket_cfg = config.ENV.OUTPUT.BUCKET
    if not bucket_cfg.get("ENABLED", False):
        return False
    try:
        from b2sdk.v2 import B2Api, InMemoryAccountInfo
    except ImportError:
        logger.warning("ENV.OUTPUT.BUCKET.ENABLED but b2sdk not installed; skipping")
        return False
    api = B2Api(InMemoryAccountInfo())
    api.authorize_account(
        "production", bucket_cfg.APP_KEY_ID, bucket_cfg.APP_KEY
    )
    bucket = api.get_bucket_by_name(bucket_cfg.BUCKET)
    since = _last_sync_mtime.get(local_dir, 0.0)
    newest = since
    uploaded = skipped = 0
    for root, _dirs, files in os.walk(local_dir):
        for fname in files:
            local_path = os.path.join(root, fname)
            try:
                mtime = os.path.getmtime(local_path)
            except OSError:
                continue
            if mtime <= since:
                skipped += 1
                continue
            rel = os.path.relpath(local_path, local_dir)
            bucket.upload_local_file(local_path, rel)
            uploaded += 1
            newest = max(newest, mtime)
    _last_sync_mtime[local_dir] = newest
    logger.info(
        f"Synced {uploaded} files to b2://{bucket_cfg.BUCKET}"
        + (f" ({skipped} unchanged skipped)" if skipped else "")
    )
    return True


def resolve_checkpoint_path(path_or_uri: str, cache_dir: str | None = None) -> str:
    """Resolve a checkpoint reference to a local path.

    Supports: local paths and 'b2://bucket/key' (b2sdk) — reference:
    utils/checkpoint_utils.py:14-104; 'hf://org/repo/file' raises by name.
    Downloads are cached in ``cache_dir``.
    """
    if path_or_uri.startswith("hf://"):
        raise NotImplementedError(
            f"checkpoint {path_or_uri!r}: hf:// (a download from the Hugging Face hub) is not "
            "part of the port; give a local file or a b2:// path")
    if path_or_uri.startswith("b2://"):
        try:
            from b2sdk.v2 import B2Api, InMemoryAccountInfo
        except ImportError as e:
            raise RuntimeError("b2:// checkpoint requires b2sdk") from e
        rest = path_or_uri[len("b2://"):]
        bucket_name, key = rest.split("/", 1)
        cache_dir = cache_dir or os.path.expanduser("~/.cache/linnaeus_tpu")
        local = os.path.join(cache_dir, bucket_name, key)
        if os.path.exists(local):
            return local
        os.makedirs(os.path.dirname(local), exist_ok=True)
        api = B2Api(InMemoryAccountInfo())
        api.authorize_account(
            "production",
            os.environ.get("B2_APP_KEY_ID", ""),
            os.environ.get("B2_APP_KEY", ""),
        )
        bucket = api.get_bucket_by_name(bucket_name)
        downloaded = bucket.download_file_by_name(key)
        downloaded.save_to(local)
        return local
    return path_or_uri


def copy_checkpoint_local(src: str, dst_dir: str) -> str:
    """Cache a checkpoint directory locally (e.g. scratch -> local SSD)."""
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, os.path.basename(src.rstrip("/")))
    if os.path.isdir(src):
        if not os.path.exists(dst):
            shutil.copytree(src, dst)
    else:
        shutil.copy(src, dst)
    return dst
