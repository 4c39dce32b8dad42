"""Developer and operations utilities: remote sync, S3 transfer, dotdict
(the JAX package's ``utils/ops.py``, the reference's ``utils.py`` and
``cmdutil.py`` surface: rsync/ssh to rented GPU boxes, S3 upload and
download, ``dotdict``).

Nothing here is on a training path, and nothing runs at import: rsync
runs only when a function is called without ``dry_run``, and ``boto3`` is
imported only by the S3 calls, which raise a clear ``ImportError`` where
it is not installed.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path
from typing import Optional, Sequence


class dotdict(dict):
    """Attribute access for dict keys (reference: utils.py:98-119)."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


def load_secrets(path: str | Path = "secrets.json") -> dict:
    """The optional credentials file ({'wandb_key', 'aws_access_key_id',
    ...}); {} when it is absent. Never read at import, never required."""
    p = Path(path)
    if not p.exists():
        return {}
    return json.loads(p.read_text())


def sync(remote: str, local_dir: str | Path = ".",
         remote_dir: str = "~/sparse_coding_tpu", port: Optional[int] = None,
         excludes: Sequence[str] = (".git", "__pycache__", "activation_data",
                                    "output"),
         dry_run: bool = False) -> list[str]:
    """rsync the working tree to a remote box (reference: utils.py:30-96).
    Returns the argv (run unless ``dry_run``)."""
    cmd = ["rsync", "-avz", "--delete"]
    for e in excludes:
        cmd += ["--exclude", e]
    if port is not None:
        cmd += ["-e", f"ssh -p {port}"]
    cmd += [str(Path(local_dir)) + "/", f"{remote}:{remote_dir}/"]
    if not dry_run:
        subprocess.run(cmd, check=True)
    return cmd


def copy_models(remote: str, remote_path: str,
                local_dir: str | Path = "models", port: Optional[int] = None,
                dry_run: bool = False) -> list[str]:
    """Pull trained artifacts back into ``local_dir`` (made if missing;
    reference: utils.py copy_models). Returns the argv (run unless
    ``dry_run``)."""
    Path(local_dir).mkdir(parents=True, exist_ok=True)
    cmd = ["rsync", "-avz"]
    if port is not None:
        cmd += ["-e", f"ssh -p {port}"]
    cmd += [f"{remote}:{remote_path}", str(local_dir) + "/"]
    if not dry_run:
        subprocess.run(cmd, check=True)
    return cmd


def _s3_client(secrets: Optional[dict] = None):
    try:
        import boto3
    except ImportError as e:
        raise ImportError(
            "boto3 not installed; S3 transfer unavailable") from e
    secrets = secrets or load_secrets()
    kwargs = {}
    if "aws_access_key_id" in secrets:
        kwargs = dict(aws_access_key_id=secrets["aws_access_key_id"],
                      aws_secret_access_key=secrets["aws_secret_access_key"])
    return boto3.client("s3", **kwargs)


def upload_to_aws(local_path: str | Path, bucket: str,
                  s3_key: Optional[str] = None,
                  secrets: Optional[dict] = None) -> str:
    """Upload a file; returns its s3:// URL (reference: utils.py:128-160)."""
    local_path = Path(local_path)
    key = s3_key or local_path.name
    _s3_client(secrets).upload_file(str(local_path), bucket, key)
    return f"s3://{bucket}/{key}"


def download_from_aws(bucket: str, s3_key: str, local_path: str | Path,
                      secrets: Optional[dict] = None) -> Path:
    """Download an object to ``local_path`` (its folder made if missing;
    reference: utils.py:162-201)."""
    local_path = Path(local_path)
    local_path.parent.mkdir(parents=True, exist_ok=True)
    _s3_client(secrets).download_file(bucket, s3_key, str(local_path))
    return local_path
