"""The port's multi-process layer (smalltts_tpu_torch/parallel/multihost.py),
the loader's process offset and the trainers' --dp, in one process on the
CPU: joining a job from the environment (torch.distributed's
init_process_group monkeypatched where a real job would start), single-writer
checkpoints read back by the JAX package, rank 1's data stream against the
JAX package's process 1, and the command lines' --dp reaching auto_mesh.
The process-group checks are in tests/test_torch_parallel.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from smalltts_tpu.data import local as JL  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu_torch.data import local as PL  # noqa: E402
from smalltts_tpu_torch.data import synthetic as PS  # noqa: E402
from smalltts_tpu_torch.parallel import multihost  # noqa: E402
from smalltts_tpu_torch.train import distill as PDS  # noqa: E402
from smalltts_tpu_torch.train import teacher as PT  # noqa: E402

LAUNCHER_VARS = ("SMALLTTS_COORDINATOR", "SMALLTTS_NUM_PROCESSES", "SMALLTTS_PROCESS_ID",
                 "SMALLTTS_LOCAL_DEVICE_IDS", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.fixture
def fake_dist(clean_env):
    """torch.distributed with init_process_group recorded, not run; the
    group it would make answers rank 1 of 2."""
    import torch.distributed as dist

    calls = []
    state = {"on": False}

    def init(backend, **kw):
        calls.append((backend, kw))
        state["on"] = True

    clean_env.setattr(dist, "init_process_group", init)
    clean_env.setattr(dist, "is_initialized", lambda: state["on"])
    clean_env.setattr(dist, "get_rank", lambda group=None: 1)
    clean_env.setattr(dist, "get_world_size", lambda group=None: 2)
    clean_env.setattr(dist, "get_backend", lambda group=None: calls[-1][0])
    return clean_env, calls


def test_initialize_from_env_noop_without_coordinator(clean_env):
    info = multihost.initialize_from_env()
    assert info["distributed"] is False and info["num_processes"] == 1 and info["process_id"] == 0
    assert multihost.is_coordinator() and multihost.process_index() == 0
    assert multihost.auto_mesh() is None
    multihost.barrier()  # a no-op in one process


@pytest.mark.parametrize("num,pid", [("", "0"), ("2", None), ("two", "1")])
def test_malformed_env_raises(clean_env, num, pid):
    clean_env.setenv("SMALLTTS_COORDINATOR", "127.0.0.1:1234")
    clean_env.setenv("SMALLTTS_NUM_PROCESSES", num)
    if pid is not None:
        clean_env.setenv("SMALLTTS_PROCESS_ID", pid)
    with pytest.raises(RuntimeError, match="SMALLTTS_NUM_PROCESSES / SMALLTTS_PROCESS_ID"):
        multihost.initialize_from_env()


def test_smalltts_env_joins_over_tcp(fake_dist):
    env, calls = fake_dist
    env.setenv("SMALLTTS_COORDINATOR", "10.0.0.1:4321")
    env.setenv("SMALLTTS_NUM_PROCESSES", "2")
    env.setenv("SMALLTTS_PROCESS_ID", "1")
    info = multihost.initialize_from_env()
    assert calls == [("gloo", {"init_method": "tcp://10.0.0.1:4321", "world_size": 2, "rank": 1})]
    assert info == {"distributed": True, "coordinator": "10.0.0.1:4321", "process_id": 1, "num_processes": 2,
                    "local_devices": 1, "global_devices": 2, "backend": "gloo"}
    assert not multihost.is_coordinator()


def test_launcher_env_triggers_env_init(fake_dist):
    """A launcher's environment (torchrun's WORLD_SIZE > 1, RANK,
    MASTER_ADDR) joins through env://: the counterpart of the JAX package's
    test_pod_env_triggers_argless_initialize."""
    env, calls = fake_dist
    env.setenv("WORLD_SIZE", "2")
    env.setenv("RANK", "1")
    env.setenv("LOCAL_RANK", "1")
    env.setenv("MASTER_ADDR", "127.0.0.1")
    env.setenv("MASTER_PORT", "29500")
    info = multihost.initialize_from_env()
    assert calls == [("gloo", {"init_method": "env://"})]
    assert info["distributed"] is True and info["coordinator"].startswith("env://")


def test_single_process_launcher_stays_single(fake_dist):
    env, calls = fake_dist
    env.setenv("WORLD_SIZE", "1")
    env.setenv("RANK", "0")
    env.setenv("MASTER_ADDR", "127.0.0.1")
    assert multihost.initialize_from_env()["distributed"] is False and calls == []


def test_auto_mesh_needs_a_process_per_device(clean_env):
    """--dp 2 in one process: one process drives one device here, so the
    error names the launch that gives it two."""
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        multihost.auto_mesh(dp=2)


def test_batch_helpers_without_a_process_group(clean_env):
    """data_sharding is the JAX package's spec; shard_batch keeps this rank's
    dp rows of a global batch (rank 0 without a group) and drops texts;
    local_batch_to_global takes each process's own slice as it is, as
    tensors: the counterpart of test_local_batch_to_global_single_process."""
    from jax.sharding import PartitionSpec as P

    from smalltts_tpu_torch.parallel import mesh as PM

    assert PM.data_sharding(PM.make_mesh(dp=2, devices=range(2)), 3) == tuple(P("dp", None, None))
    batch = {"latents": np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2),
             "lengths": np.array([3, 3, 2, 1], np.int32), "texts": ["dropped"]}
    rows = PM.shard_batch(batch, PM.make_mesh(dp=2, devices=range(2)))
    assert rows.keys() == {"latents", "lengths"} and np.array_equal(rows["latents"], batch["latents"][:2])
    out = multihost.local_batch_to_global(batch, PM.make_mesh())
    assert out.keys() == {"latents", "lengths"} and torch.equal(out["lengths"], torch.tensor([3, 3, 2, 1]))
    with pytest.raises(ValueError, match="does not divide"):
        PM.shard_batch({"x": np.zeros((3, 2))}, PM.make_mesh(dp=2, devices=range(2)))


def test_save_on_coordinator_single_process(clean_env, tmp_path):
    """One process is the coordinator: it writes, and the JAX package's
    load_pytree reads the file back."""
    tree = {"a": torch.ones(3, 2), "b": {"c": torch.arange(4.0)}}
    path = str(tmp_path / "ck.npz")
    assert multihost.save_on_coordinator(path, tree) is True
    loaded = jckpt.load_pytree(path)
    np.testing.assert_array_equal(loaded["a"], np.ones((3, 2), np.float32))
    np.testing.assert_array_equal(loaded["b"]["c"], np.arange(4.0, dtype=np.float32))
    fetched = multihost.fetch_replicated(tree)
    assert fetched["a"].device.type == "cpu" and torch.equal(fetched["b"]["c"], tree["b"]["c"])


HOP = 20
CFG = dict(batch_size=2, latent_dim=8, max_phonemes=32, max_latents=24, max_ref=8, min_latents=4, hop=HOP)


def fake_encode(audio):
    """(B, 1, T) -> (B, T // HOP, 8): each frame's mean and its index (as tests/test_torch_data.py)."""
    b, _, t = audio.shape
    frames = audio[:, 0, : (t // HOP) * HOP].reshape(b, t // HOP, HOP)
    feat = np.zeros((b, t // HOP, 8), np.float32)
    feat[..., 0] = frames.mean(-1)
    feat[..., 1] = np.arange(t // HOP)[None, :]
    return feat


def _first(it, n=3):
    return [next(it) for _ in range(n)]


def test_loader_rank_offset_matches_jax_process_stream(tmp_path, monkeypatch):
    """Rank 1's batches equal the JAX loader's with process_index() = 1 (the
    seed + 100_003 x the rank); rank 0's stream is the seed's own, as
    before; the two ranks sample apart."""
    PS.write_corpus(str(tmp_path), n_utts=5, n_speakers=2, seed=1)
    streams = {}
    for rank in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
        monkeypatch.setattr(PL, "process_index", lambda rank=rank: rank)
        want = _first(JL.get_local_dataloader(str(tmp_path), fake_encode, JL.LocalDataConfig(**CFG), seed=3))
        got = _first(PL.get_local_dataloader(str(tmp_path), fake_encode, PL.LocalDataConfig(**CFG), seed=3))
        for w, g in zip(want, got):
            assert g.keys() == w.keys()
            for k in w:
                assert (g[k] == w[k]) if k == "texts" else np.array_equal(g[k], w[k]), (rank, k)
        streams[rank] = got
    assert any(not np.array_equal(a["latents"], b["latents"]) for a, b in zip(streams[0], streams[1]))


@pytest.mark.parametrize("cli", ["teacher", "distill"])
def test_cli_dp_reaches_auto_mesh(cli, tmp_path, monkeypatch):
    """--dp N goes to auto_mesh(dp=N, tp=1), and its mesh to the trainer."""
    calls = {}
    mesh = object()

    def fake_auto_mesh(dp=0, tp=1):
        calls["auto_mesh"] = (dp, tp)
        return mesh

    monkeypatch.setattr(multihost, "auto_mesh", fake_auto_mesh)
    if cli == "teacher":
        monkeypatch.setattr(PT, "train_teacher", lambda *a, **kw: calls.setdefault("mesh", kw["mesh"]))
        PT.main(["--steps", "1", "--dp", "3"])
    else:
        for name in ("t.npz", "a.npz", "s.npz"):
            (tmp_path / name).write_bytes(b"")
        monkeypatch.setattr(PDS, "train_distill", lambda *a, **kw: calls.setdefault("mesh", kw["mesh"]))
        PDS.main(["--teacher", str(tmp_path / "t.npz"), "--asr", str(tmp_path / "a.npz"), "--sv",
                  str(tmp_path / "s.npz"), "--steps", "1", "--dp", "3"])
    assert calls == {"auto_mesh": (3, 1), "mesh": mesh}

