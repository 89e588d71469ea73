"""The port's quality and cost tools against the JAX package's, on the CPU:
utils/metrics.py (the numpy functions bit for bit; sv_similarity through
the voxceleb ECAPA, JAX's weights carried across, 1e-5 of the similarity),
utils/flops.py (the H100's published peaks, FlopCounterMode's 2MNK for a
matmul, utilization's arithmetic equal to JAX's on the same peaks),
utils/profiling.trace / annotate (a Chrome trace holding the annotated
range), and the entry points scripts/eval_quality (--roundtrip
--synthetic 1 against the JAX script on the same tiny checkpoints: mel
distance within 1e-3, SNR within 0.05 dB of its rounded values) and
scripts/profile (--runs 1), with tests/tiny.py's configs.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu.models import backbone as JB  # noqa: E402
from smalltts_tpu.models import codec as JC  # noqa: E402
from smalltts_tpu.models import sv_teacher as JT  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu.utils import config_io as jcio  # noqa: E402
from smalltts_tpu.utils import flops as jflops  # noqa: E402
from smalltts_tpu.utils import metrics as JM  # noqa: E402
from smalltts_tpu_torch.models import codec as PCo  # noqa: E402
from smalltts_tpu_torch.models import sv as PSV  # noqa: E402
from smalltts_tpu_torch.utils import flops as pflops  # noqa: E402
from smalltts_tpu_torch.utils import metrics as PM  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax  # noqa: E402
from smalltts_tpu_torch.utils.profiling import annotate, trace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def waves(seconds=0.5, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * 24_000)) / 24_000
    a = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rs.randn(t.size)).astype(np.float32)
    b = (0.3 * np.sin(2 * np.pi * 240 * t + 0.3) + 0.05 * rs.randn(t.size)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("fn", ["probe_sine", "mel_filterbank", "log_mel_spectrogram", "log_mel_short",
                                "mel_distance", "snr_db"])
def test_numpy_functions_bit_for_bit(fn):
    a, b = waves()
    calls = {"probe_sine": lambda m: m.probe_sine(1.5, 24_000, 330.0),
             "mel_filterbank": lambda m: m.mel_filterbank(16_000, 512, 40, 60.0, 7000.0),
             "log_mel_spectrogram": lambda m: m.log_mel_spectrogram(a),
             "log_mel_short": lambda m: m.log_mel_spectrogram(a[:300]),  # shorter than n_fft: padded
             "mel_distance": lambda m: m.mel_distance(a, b[:9000]),
             "snr_db": lambda m: m.snr_db(a, a + 0.01 * b)}
    got, want = calls[fn](PM), calls[fn](JM)
    assert type(got) is type(want)
    np.testing.assert_array_equal(got, want)


def test_sv_similarity_with_the_waveform_teacher_matches_jax():
    jp = JT.init_sv_teacher(jax.random.PRNGKey(0))
    pcfg = PSV.SVConfig(**dataclasses.asdict(JT.VOXCELEB_ECAPA))
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), pcfg)
    a, b = waves()
    want = JM.sv_similarity(a, b, teacher_params=jp)
    got = PM.sv_similarity(a, b, teacher_params=pp)
    assert abs(got - want) <= 1e-5 * abs(want) and -1.0 <= got <= 1.0
    assert abs(PM.sv_similarity(a, a, teacher_params=pp) - 1.0) <= 1e-6


def test_sv_similarity_without_sv_weights_warns_and_keeps_its_random_sv():
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict

    tts = SmallTTS(cfg=backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE)),
                   codec_cfg=PCo.CodecConfig(**dataclasses.asdict(TINY_CODEC)), device="cpu")
    a, b = waves()
    with pytest.warns(UserWarning, match="random-init"):
        sim = PM.sv_similarity(a, b, tts=tts)
    assert -1.0 <= sim <= 1.0 and tts._sv_params is not None
    assert PM.sv_similarity(a, b, tts=tts) == sim  # the same random SV, no second warning needed


def test_device_peaks_of_the_h100_and_unknown_cards(monkeypatch):
    monkeypatch.delenv("SMALLTTS_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("SMALLTTS_PEAK_GBPS", raising=False)
    assert pflops.device_peaks(H100) == (989.0, 3350.0)
    with pytest.raises(ValueError, match="no published peaks"):
        pflops.device_peaks("TPU v5 lite")
    monkeypatch.setenv("SMALLTTS_PEAK_GBPS", "1000")
    assert pflops.device_peaks(H100) == (989.0, 1000.0)
    with pytest.raises(ValueError, match="SMALLTTS_PEAK_TFLOPS"):
        pflops.device_peaks("Some Other Card")
    monkeypatch.setenv("SMALLTTS_PEAK_TFLOPS", "50")
    assert pflops.device_peaks("Some Other Card") == (50.0, 1000.0)


@pytest.mark.parametrize("m,n,k", [(64, 48, 32), (7, 5, 3)])
def test_compiled_cost_of_a_matmul_is_2mnk(m, n, k):
    a, b = torch.randn(m, k), torch.randn(k, n)
    cost = pflops.compiled_cost(torch.matmul, a, b)
    assert cost == {"flops": 2.0 * m * n * k, "bytes": 4.0 * (m * k + k * n + m * n)}
    assert pflops.compiled_cost(torch.add, a, a) is None  # no FLOP counted


@pytest.mark.parametrize("batched", [False, True])
def test_compiled_cost_counts_out_dtype_products(batched):
    """torch.mm / torch.bmm with out_dtype=float32 (nn.matmul_f32's bf16
    path on the card; meta tensors here, where the CPU has no such kernel)
    count 2 M N K a product, as without out_dtype; FlopCounterMode's own
    formulas raised on them."""
    lead = (3,) if batched else ()
    a = torch.empty(*lead, 5, 7, dtype=torch.bfloat16, device="meta")
    b = torch.empty(*lead, 7, 4, dtype=torch.bfloat16, device="meta")
    op = torch.bmm if batched else torch.mm
    cost = pflops.compiled_cost(lambda x, y: op(x, y, out_dtype=torch.float32), a, b)
    assert cost["flops"] == 2 * (3 if batched else 1) * 5 * 7 * 4
    assert pflops.compiled_cost(op, a, b)["flops"] == cost["flops"]


def test_compiled_cost_of_a_codec_decode_counts_its_convolutions():
    cfg = PCo.CodecConfig(**dataclasses.asdict(TINY_CODEC))
    p = PCo.init_codec(torch.Generator().manual_seed(0), cfg)
    lat = torch.randn(1, 2, 64)
    with torch.no_grad():
        cost = pflops.compiled_cost(PCo.codec_decode, p, lat, cfg)
    assert cost["flops"] > 0 and cost["bytes"] >= 4 * (lat.numel() + 2 * cfg.hop)


def test_utilization_matches_jax(monkeypatch):
    monkeypatch.setenv("SMALLTTS_PEAK_TFLOPS", "989")
    monkeypatch.setenv("SMALLTTS_PEAK_GBPS", "3350")
    args = (4.1e12, 2.3e10, 0.0123)
    assert pflops.utilization(*args) == jflops.utilization(*args)
    monkeypatch.delenv("SMALLTTS_PEAK_TFLOPS")
    monkeypatch.delenv("SMALLTTS_PEAK_GBPS")
    got = pflops.utilization(*args, device=H100)
    assert got["peak_tflops"] == 989.0 and got["mfu"] == round(4.1e12 / 0.0123 / 1e12 / 989.0, 4)


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        with annotate("codec_decode_range"):
            torch.randn(32, 16) @ torch.randn(16, 8)
    assert os.path.dirname(prof.trace_file) == str(tmp_path / "tr")
    with open(prof.trace_file) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "codec_decode_range" in names and any("mm" in str(n) for n in names)


@pytest.fixture(scope="module")
def tiny_checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_ckpt")
    jckpt.save_pytree(str(d / "backbone.npz"), JB.init_backbone(jax.random.PRNGKey(0), TINY_BACKBONE),
                      meta=jcio.backbone_meta(TINY_BACKBONE))
    jckpt.save_pytree(str(d / "codec.npz"), JC.init_codec(jax.random.PRNGKey(1), TINY_CODEC),
                      meta=jcio.codec_meta(TINY_CODEC))
    return d


def test_eval_quality_roundtrip_matches_the_jax_script(tiny_checkpoints, tmp_path, monkeypatch, capsys):
    from smalltts_tpu_torch.scripts import eval_quality

    d = tiny_checkpoints
    common = ["--roundtrip", "--synthetic", "1", "--checkpoint", str(d / "backbone.npz"), "--codec", "native",
              "--codec-checkpoint", str(d / "codec.npz")]
    assert eval_quality.main(common + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spec = importlib.util.spec_from_file_location("eval_quality_script", os.path.join(ROOT, "scripts",
                                                                                      "eval_quality.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["eval_quality.py"] + common + ["--out", str(tmp_path / "jax.json")])
    assert script.main() == 0
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, want = (json.load(open(tmp_path / f)) for f in ("port.json", "jax.json"))
    assert line == {"mode": "roundtrip", **got["roundtrip"]} and want_line["mode"] == "roundtrip"
    assert got["roundtrip"]["n"] == want["roundtrip"]["n"] == 1
    assert abs(got["roundtrip"]["mel_distance"] - want["roundtrip"]["mel_distance"]) <= 1e-3
    assert abs(got["roundtrip"]["snr_db"] - want["roundtrip"]["snr_db"]) <= 0.05
    assert eval_quality.main(["--device", "cpu", "--checkpoint", str(d / "backbone.npz"), "--codec-checkpoint",
                              str(d / "codec.npz")]) == 1  # no mode: nothing to do


def test_profile_traces_one_run(tiny_checkpoints, tmp_path, monkeypatch, capsys):
    from smalltts_tpu_torch.infer import pipeline
    from smalltts_tpu_torch.scripts import profile

    monkeypatch.setattr(pipeline, "CodecConfig", lambda: PCo.CodecConfig(**dataclasses.asdict(TINY_CODEC)))
    out = tmp_path / "trace"
    assert profile.main(["--out", str(out), "--runs", "1", "--batch", "1", "--duration", "1.0", "--checkpoint",
                         str(tiny_checkpoints / "backbone.npz"), "--device", "cpu"]) == 0
    assert "trace written to" in capsys.readouterr().out
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert '"synthesize_padded"' in open(out / files[0]).read()


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from smalltts_tpu_torch.scripts import eval_quality, profile

    for main in (profile.main, eval_quality.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--runs", "1"] if main is profile.main else ["--roundtrip"])
