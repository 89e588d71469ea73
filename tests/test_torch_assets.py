"""The port's asset fetcher (smalltts_tpu_torch/assets/ensure.py) against
the JAX package's (smalltts_tpu/assets/ensure.py), with huggingface_hub
blocked or replaced by a stub: nothing is downloaded.

- folders already present: the hub is never touched;
- folders missing and huggingface_hub unavailable: the same RuntimeError;
- a stub whose snapshot_download writes files into the staging directory:
  the same tree in place, no `.partial-*` directory left;
- a stub that downloads nothing: the same "has no files" error.
"""

import os
import sys
import types

import pytest

from smalltts_tpu.assets import ensure as jensure
from smalltts_tpu_torch.assets import ensure

FOLDERS = ["tryme", "codec", "dmd"]


def _tree(root):
    return sorted((os.path.relpath(os.path.join(d, f), root), open(os.path.join(d, f), "rb").read())
                  for d, _, fs in os.walk(root) for f in fs)


def _stub(calls, files):
    """A huggingface_hub whose snapshot_download writes `files` (relative
    name -> bytes) under <local_dir>/<folder>/ for each allowed folder."""
    hub = types.ModuleType("huggingface_hub")

    class HfApi:
        def model_info(self, repo):
            calls.append(("model_info", repo))

        def dataset_info(self, repo):
            calls.append(("dataset_info", repo))

    def snapshot_download(repo, repo_type, local_dir, allow_patterns):
        calls.append(("snapshot_download", repo, repo_type, os.path.basename(local_dir), tuple(allow_patterns)))
        for pattern in allow_patterns:
            folder = pattern.split("/")[0]
            for name, data in files.items():
                path = os.path.join(local_dir, folder, name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(data)

    hub.HfApi, hub.snapshot_download = HfApi, snapshot_download
    return hub


def test_present_folders_touch_nothing(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "huggingface_hub", _stub(calls, {"x": b"1"}))
    for f in FOLDERS:
        (tmp_path / f).mkdir()
    ensure.ensure_assets(FOLDERS, root=str(tmp_path))
    jensure.ensure_assets(FOLDERS, root=str(tmp_path))
    assert calls == []


def test_missing_folders_without_the_hub_raise_the_same_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    (tmp_path / "codec").mkdir()
    errors = []
    for mod in (jensure, ensure):
        with pytest.raises(RuntimeError) as exc:
            mod.ensure_assets(FOLDERS, root=str(tmp_path))
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert "['tryme', 'dmd']" in errors[1] and "huggingface_hub is unavailable" in errors[1]


def test_stub_download_lands_the_same_tree(tmp_path, monkeypatch):
    files = {"latents.npy": b"\x93NUMPY", "sub/graph.onnx": b"onnx bytes"}
    trees, logs = [], []
    for name, mod in (("jax", jensure), ("port", ensure)):
        calls = []
        monkeypatch.setitem(sys.modules, "huggingface_hub", _stub(calls, files))
        root = tmp_path / name
        (root / "codec").mkdir(parents=True)
        (root / "codec" / "kept").write_bytes(b"present")
        mod.ensure_assets(FOLDERS, root=str(root))
        assert not [d for d in os.listdir(root) if d.startswith(".partial-")]
        trees.append(_tree(str(root)))
        logs.append(calls)
    assert trees[0] == trees[1]
    assert ("dmd/sub/graph.onnx", b"onnx bytes") in trees[1] and ("codec/kept", b"present") in trees[1]
    assert logs[0] == logs[1]
    assert ("snapshot_download", ensure.REPO, "model", ".partial-tryme", ("tryme/*",)) in logs[1]


def test_empty_download_raises_has_no_files(tmp_path, monkeypatch):
    errors = []
    for name, mod in (("jax", jensure), ("port", ensure)):
        monkeypatch.setitem(sys.modules, "huggingface_hub", _stub([], {}))
        root = tmp_path / name
        with pytest.raises(RuntimeError) as exc:
            mod.ensure_assets(["dmd"], root=str(root))
        errors.append(str(exc.value).replace(str(root), "<root>"))
        assert not (root / "dmd").exists()
    assert errors[0] == errors[1] and "has no files under dmd/" in errors[1]
