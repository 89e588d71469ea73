"""Asset management: idempotent fetch of model weights from a model hub
(port of smalltts_tpu/assets/ensure.py).

Skip a folder that `assets/<folder>` already holds; else snapshot-download
only that folder through `huggingface_hub` into a `.partial-<folder>`
staging directory and put it in place with one rename, so an interrupted
fetch never looks complete. The repo type (model or dataset) is probed.
Without `huggingface_hub`, or without a network, it raises RuntimeError
with the reason instead of hanging. Usable as a command:

    python -m smalltts_tpu_torch.assets.ensure [folder ...]
"""

from __future__ import annotations

import os
import sys
from typing import Iterable

REPO = os.environ.get("SMALLTTS_ASSET_REPO", "smallbraineng/smalltts")
ASSETS_ROOT = os.environ.get("SMALLTTS_ASSETS", "assets")


def _repo_type() -> str:
    from huggingface_hub import HfApi

    api = HfApi()
    try:
        api.model_info(REPO)
        return "model"
    except Exception:
        try:
            api.dataset_info(REPO)
            return "dataset"
        except Exception:
            return "model"


def ensure_assets(folders: Iterable[str], root: str = ASSETS_ROOT) -> None:
    """Download each `folder` from the asset repo unless already present."""
    missing = [f for f in folders if not os.path.isdir(os.path.join(root, f))]
    if not missing:
        return
    try:
        from huggingface_hub import snapshot_download
    except ImportError as exc:
        raise RuntimeError(
            f"assets {missing} not present under {root!r} and huggingface_hub "
            "is unavailable; place weights manually"
        ) from exc
    try:
        import shutil

        repo_type = _repo_type()
        for folder in missing:
            print(f"downloading assets/{folder} from {REPO} ({repo_type})")
            staging = os.path.join(root, f".partial-{folder}")
            shutil.rmtree(staging, ignore_errors=True)
            snapshot_download(REPO, repo_type=repo_type, local_dir=staging, allow_patterns=[f"{folder}/*"])
            got = os.path.join(staging, folder)
            if not os.path.isdir(got) or not os.listdir(got):
                raise RuntimeError(f"{REPO} has no files under {folder}/ (wrong repo?)")
            os.makedirs(root, exist_ok=True)
            final = os.path.join(root, folder)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(got, final)
            shutil.rmtree(staging, ignore_errors=True)
    except Exception as exc:  # offline or no network
        raise RuntimeError(
            f"downloading assets {missing} from {REPO} failed ({exc}); "
            "place weights manually or run offline"
        ) from exc


if __name__ == "__main__":
    ensure_assets(sys.argv[1:] or ["tryme", "codec", "dmd"])
