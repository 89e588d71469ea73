"""Card-only: the pipeline's CUDA graphs, one per bucket shape
(smalltts_tpu_torch/infer/pipeline.py). Skipped where there is no CUDA
card. On a card machine, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py

- A replay equals the eager synthesize fn bit for bit on the same inputs
  and noise: the graph holds the same kernels with the same launch
  parameters, so nothing is summed in another order.
- Two fetch=False replays of one bucket back to back each keep their own
  result (the pipeline returns a copy of the graph's static output).
- A first-use capture runs while another thread copies results to the host.
- The launch counts taken while a full-width batch of 8 is captured are the
  scan's 384 (4 steps x 12 layers x 8 launches) and each replay adds them.
- An IMF checkpoint (r_gate drawn from N(0, 0.1)) serves through IMF-2: its
  full-width graph replays equal to eager, bit for bit, with 192 scan
  launches a batch of 8 (2 steps x 12 layers x 8).
- A SmallTTS with the ONNX codec (the port's codec exported, then
  interpreted): its graph replays equal to eager, bit for bit, and the
  interpreted decoder equals the native codec within 1e-5 of the largest
  sample (fp32, TF32 off).
"""

import threading

import numpy as np
import pytest
import torch

from smalltts_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda
GEMMS = ("gemm_bias", "gemm_swiglu", "gemm_residual")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def small_tts(dev, seed=12):
    """Small widths that the kernels take (DiT head dim 120, encoder 64)."""
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import CodecConfig
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig

    enc = EncoderConfig(model_size=128, num_layers=2, num_heads=2, intermediate_size=256, norm_eps=1e-6)
    cfg = BackboneConfig(hidden_dim=240, phoneme_dim=128, text=enc, style=enc,
                         dit=DiTConfig(phoneme_dim=128, hidden_dim=240, n_blocks=2, heads=2))
    g = torch.Generator(device=dev).manual_seed(seed)
    params = redraw_zero_init(init_backbone(g, cfg, device=dev), g)
    return SmallTTS(params, cfg=cfg, codec_cfg=CodecConfig(channels=(16, 16, 16, 8, 8, 4)), pcm16_out=True)


@pytest.fixture(scope="module")
def full_tts(dev):
    """Full width (default configs), bf16, seed-0 weights."""
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init

    g = torch.Generator(device=dev).manual_seed(0)
    params = redraw_zero_init(init_backbone(g, BackboneConfig(), device=dev), g)
    return SmallTTS(params, pcm16_out=True, seed=0)


def batch(B, R, P, T, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, R, 64).astype(np.float32), rs.randint(R // 2, R + 1, B), rs.randint(1, 198, (B, P)),
            rs.randint(1, P + 1, B), rs.randint(1, T + 1, B), T)


def eager(tts, args, noises):
    r, rl, ph, pl, sl, T = args
    with torch.inference_mode():
        return tts._synthesize_fn(tts.params, tts.codec_params, tts._tensor(r, tts.dtype),
                                  tts._tensor(rl, torch.int32), tts._tensor(ph, torch.int64),
                                  tts._tensor(pl, torch.int32), tts._tensor(sl, torch.int32), noises, t_bucket=T)


def noise(tts, args, seed):
    from smalltts_tpu_torch.infer.sampler import noise_draws

    g = torch.Generator(device=tts.device).manual_seed(seed)
    return torch.randn((noise_draws(tts.sampler, tts.num_steps), len(args[4]), args[5], 64), generator=g,
                       device=tts.device).to(tts.dtype)


@pytest.mark.parametrize("width", ["small", "full"])
def test_replay_equals_eager_bit_for_bit(dev, full_tts, width):
    tts = small_tts(dev) if width == "small" else full_tts
    args = batch(8, 64, 384, 40) if width == "full" else batch(2, 64, 128, 16)
    n = noise(tts, args, 1)
    n0 = tts.compile_cache_size()
    got = tts.synthesize_padded(*args, fetch=False, noises=n)  # captured here, then replayed
    again = tts.synthesize_padded(*args, fetch=False, noises=n)
    want = eager(tts, args, n)
    torch.cuda.synchronize()
    assert tts.compile_cache_size() == n0 + 1
    assert got.dtype == torch.int16 and int(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(again, want)


def test_two_replays_of_one_bucket_keep_their_own_results(dev):
    tts = small_tts(dev)
    args = batch(2, 64, 128, 16, seed=3)
    tts.synthesize_padded(*args)  # capture
    n1, n2 = noise(tts, args, 4), noise(tts, args, 5)
    out1 = tts.synthesize_padded(*args, fetch=False, noises=n1)
    out2 = tts.synthesize_padded(*args, fetch=False, noises=n2)
    torch.cuda.synchronize()
    assert not torch.equal(out1, out2)
    assert torch.equal(out1, eager(tts, args, n1)) and torch.equal(out2, eager(tts, args, n2))
    # drawn noise: the generator draws it, outside the graph, as the eager path would
    a = tts.synthesize_padded(*args, fetch=False)
    b = tts.synthesize_padded(*args, fetch=False)
    assert not torch.equal(a, b)


def test_first_use_capture_while_another_thread_copies_to_the_host(dev):
    tts = small_tts(dev)
    first = batch(2, 64, 128, 16, seed=6)
    held = tts.synthesize_padded(*first, fetch=False)
    big = torch.randn((64, 1 << 20), device=dev)
    stop, errors, copies = threading.Event(), [], [0]

    def fetch():
        try:
            while not stop.is_set():
                held.cpu()  # a synchronizing copy, as the batcher's fetch thread makes
                big.cpu()
                copies[0] += 1
        except Exception as exc:  # reported below
            errors.append(exc)

    t = threading.Thread(target=fetch)
    t.start()
    try:
        args = batch(2, 256, 384, 40, seed=7)
        n = noise(tts, args, 8)
        got = tts.synthesize_padded(*args, fetch=False, noises=n)  # a first-use capture
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert copies[0] > 0 and tts.compile_cache_size() == 2
    assert torch.equal(got, eager(tts, args, n))


def test_capture_counts_384_scan_launches_a_batch_of_8(dev, full_tts):
    args = batch(8, 64, 384, 40, seed=9)
    tts = full_tts
    tts.synthesize_padded(*args)
    g = tts._graphs[(8, 64, 384, 40)]
    per = tts.num_steps * tts.cfg.dit.n_blocks
    want = {"adaln_modulate": 2 * per, "qk_norm_rope": per, "gemm_bias": per, "gemm_swiglu": per,
            "gemm_residual": 2 * per}
    assert {k: g.launches.get(k, 0) for k in want} == want
    assert sum(want.values()) + g.launches["qk_norm_rope"] == 384  # + one attention a layer
    assert not any(g.launches.get(n + "_w8", 0) for n in GEMMS)
    kernels.reset_launches()
    r0 = g.replays
    tts.synthesize_padded(*args)
    tts.synthesize_padded(*args)
    assert g.replays == r0 + 2
    assert {k: kernels.LAUNCHES.get(k, 0) for k in want} == {k: 2 * v for k, v in want.items()}


@pytest.fixture(scope="module")
def imf_tts(dev):
    """Full width, bf16, seed-0 weights with an r_gate from N(0, 0.1)."""
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init

    g = torch.Generator(device=dev).manual_seed(0)
    params = redraw_zero_init(init_backbone(g, BackboneConfig(), device=dev), g)
    params["r_gate"] = 0.1 * torch.randn((BackboneConfig().hidden_dim,), generator=g, device=dev)
    return SmallTTS(params, pcm16_out=True, seed=0)


def test_imf_replay_equals_eager_with_192_scan_launches(dev, imf_tts):
    tts = imf_tts
    assert (tts.sampler, tts.num_steps) == ("imf", 2)
    args = batch(8, 64, 384, 40, seed=10)
    n = noise(tts, args, 11)
    assert n.shape == (1, 8, 40, 64)
    got = tts.synthesize_padded(*args, fetch=False, noises=n)
    want = eager(tts, args, n)
    torch.cuda.synchronize()
    assert int(want.abs().max()) > 0 and torch.equal(got, want)
    g = tts._graphs[(8, 64, 384, 40)]
    per = tts.num_steps * tts.cfg.dit.n_blocks
    counts = {"adaln_modulate": 2 * per, "qk_norm_rope": per, "gemm_bias": per, "gemm_swiglu": per,
              "gemm_residual": 2 * per}
    assert {k: g.launches.get(k, 0) for k in counts} == counts
    assert sum(counts.values()) + g.launches["qk_norm_rope"] == 192


def test_onnx_codec_replay_equals_eager(dev, tmp_path):
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.models.codec import codec_decode, init_codec
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, export

    base = small_tts(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    cp = init_codec(g, base.codec_cfg, device=dev)
    hop = base.codec_cfg.hop
    with kernels.force_plain():
        (tmp_path / "encoder.onnx").write_bytes(export(CodecEncoder(cp, base.codec_cfg), (torch.zeros((1, 1, 4 * hop),
                                                device=dev),), dynamic_axes={"audio": {0: "b", 2: "t"}},
                                                input_names=["audio"]))
        (tmp_path / "decoder.onnx").write_bytes(export(CodecDecoder(cp, base.codec_cfg), (torch.zeros((1, 4, 64),
                                                device=dev),), dynamic_axes={"latents": {0: "b", 1: "t"}},
                                                input_names=["latents"]))
    codec = OnnxCodec(str(tmp_path / "encoder.onnx"), str(tmp_path / "decoder.onnx"))
    lat = torch.randn((2, 16, 64), generator=g, device=dev)
    got, want = codec.decode_fn(codec.params, lat), codec_decode(cp, lat, base.codec_cfg)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    tts = SmallTTS(base.params, cfg=base.cfg, codec_cfg=base.codec_cfg, codec=codec, pcm16_out=True)
    assert tts.onnx_codec is codec
    args = batch(2, 64, 128, 16, seed=12)
    n = noise(tts, args, 13)
    out = tts.synthesize_padded(*args, fetch=False, noises=n)
    again = tts.synthesize_padded(*args, fetch=False, noises=n)
    ref = eager(tts, args, n)
    torch.cuda.synchronize()
    assert tts.compile_cache_size() == 1 and int(ref.abs().max()) > 0
    assert torch.equal(out, ref) and torch.equal(again, ref)
