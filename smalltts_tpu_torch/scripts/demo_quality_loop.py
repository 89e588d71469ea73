"""Train a tiny TTS stack from scratch and measure it, with no assets (port
of scripts/demo_quality_loop.py).

    python -m smalltts_tpu_torch.scripts.demo_quality_loop [--text "blue moon light"]
        [--codec-steps 300] [--teacher-steps 600] [--asr-steps 400] [--sv-steps 200]
        [--sample-steps 32] [--samples-out DIR] [--device cuda]

One command runs the whole framework loop on one utterance of the
synthetic-speech corpus (data/synthetic.py): codec training, latent
encoding, flow-matching teacher training, many-step CFG sampling and codec
decode, then the ASR (CTC) and SV (distillation from a waveform teacher)
auxiliaries, each stage scored with utils/metrics.py. It prints a line a
stage and one JSON summary at the end (codec, tts, asr, sv,
total_seconds). `--samples-out` writes a reference/generated wav pair and
index.json for the website's sample player.

The models are the tiny configurations below (the shape contract of the
full models at narrow widths: head dim 16 in every attention), the port's
own copies of the test suite's. The root script defaults to the CPU; this
one runs on the card unless `--device cpu` is given. On the card the
training forwards run the attention kernel in fp32 (its 3xTF32 forward
with the PyTorch backward), the fp32 teacher sampler runs it without a
gradient, and the ASR stage's CTC loss runs the CTC kernels.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import numpy as np

from smalltts_tpu_torch.models.asr import ASRConfig
from smalltts_tpu_torch.models.backbone import BackboneConfig
from smalltts_tpu_torch.models.codec import CodecConfig
from smalltts_tpu_torch.models.conformer import ConformerConfig
from smalltts_tpu_torch.models.dit import DiTConfig
from smalltts_tpu_torch.models.encoder import EncoderConfig
from smalltts_tpu_torch.models.sv import SVConfig

TINY_TEXT = EncoderConfig(model_size=32, num_layers=2, num_heads=2, intermediate_size=64, norm_eps=1e-6)
TINY_STYLE = EncoderConfig(model_size=32, num_layers=2, num_heads=2, intermediate_size=64, norm_eps=1e-5)
TINY_DIT = DiTConfig(latent_dim=64, phoneme_dim=32, hidden_dim=64, n_blocks=2, heads=4, rot_dim=8, conv_groups=16)
TINY_BACKBONE = BackboneConfig(latent_dim=64, hidden_dim=64, phoneme_dim=32, dit=TINY_DIT, text=TINY_TEXT,
                               style=TINY_STYLE)
# the real hop (3200) on skinny channels
TINY_CODEC = CodecConfig(latent_dim=64, channels=(16, 16, 16, 8, 8, 4))
TINY_ASR64 = ASRConfig(input_dim=64, conformer=ConformerConfig(input_dim=64, num_heads=4, ffn_dim=64, num_layers=2,
                                                               depthwise_conv_kernel_size=9))
TINY_SV64 = SVConfig(input_dim=64, emb_dim=8, channels=(24, 24, 24, 24, 72), attention_channels=8, res2net_scale=4,
                     se_channels=8)
# the SV stage's waveform teacher: an ECAPA over 80 fbank channels
TINY_SV_TEACHER = SVConfig(input_dim=80, channels=(16, 16, 16, 16, 48), emb_dim=8, attention_channels=8,
                           res2net_scale=2, se_channels=8)


def greedy_decode(asr, lat_gt: np.ndarray, device) -> list:
    """The ASR's greedy CTC decode of one utterance's latents (T, 64):
    argmax per frame, repeats merged, blanks (0) dropped."""
    import torch

    from smalltts_tpu_torch.models.asr import asr_forward

    with torch.no_grad():
        logp, out_lens, _ = asr_forward(asr, TINY_ASR64, torch.as_tensor(lat_gt[None], device=device),
                                        torch.tensor([lat_gt.shape[0]], dtype=torch.int32, device=device))
    pred = logp.argmax(-1)[0, : int(out_lens[0])].cpu().numpy()
    return [int(k) for k, _ in itertools.groupby(pred) if k != 0]


def teacher_cosine(sv, cp, tp, teacher_fn, lat_gt: np.ndarray, device) -> float:
    """Cosine between the SV's embedding of the latents and the waveform
    teacher's embedding of their codec decode."""
    import torch

    from smalltts_tpu_torch.models.codec import codec_decode
    from smalltts_tpu_torch.models.sv import sv_forward

    lat = torch.as_tensor(lat_gt[None], device=device)
    with torch.no_grad():
        emb, _ = sv_forward(sv, TINY_SV64, lat, torch.tensor([lat_gt.shape[0]], dtype=torch.int32, device=device))
        temb = teacher_fn(tp, codec_decode(cp, lat, TINY_CODEC))
    e, te = emb[0].double().cpu().numpy(), temb[0].double().cpu().numpy()
    return float(e @ te / (np.linalg.norm(e) * np.linalg.norm(te) + 1e-9))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train a tiny stack from scratch and measure it.")
    ap.add_argument("--text", default="blue moon light")
    ap.add_argument("--codec-steps", type=int, default=300)
    ap.add_argument("--teacher-steps", type=int, default=600)
    ap.add_argument("--asr-steps", type=int, default=400)
    ap.add_argument("--sv-steps", type=int, default=200)
    ap.add_argument("--sample-steps", type=int, default=32)
    ap.add_argument("--samples-out", default=None, metavar="DIR",
                    help="write reference/generated wav pairs + index.json "
                         "for the website sample player (server --static)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from smalltts_tpu_torch.data.synthetic import synth_speech
    from smalltts_tpu_torch.infer.teacher_sampler import make_teacher_sampler
    from smalltts_tpu_torch.models.asr import init_asr
    from smalltts_tpu_torch.models.backbone import init_backbone
    from smalltts_tpu_torch.models.codec import codec_decode, codec_encode, init_codec
    from smalltts_tpu_torch.models.sv import init_sv
    from smalltts_tpu_torch.models.sv_teacher import init_sv_teacher, make_teacher_fn
    from smalltts_tpu_torch.train.asr_train import make_asr_step
    from smalltts_tpu_torch.train.codec_train import CodecTrainConfig, make_codec_step
    from smalltts_tpu_torch.train.ema import ema_init
    from smalltts_tpu_torch.train.optim import adamw
    from smalltts_tpu_torch.train.sv_train import make_sv_step
    from smalltts_tpu_torch.train.teacher import make_teacher_step, teacher_draws
    from smalltts_tpu_torch.utils.metrics import mel_distance, snr_db
    from smalltts_tpu_torch.utils.transfer import resolve_device

    dev = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    summary = {}

    def stage(msg):
        sync()
        print(f"[{time.time() - t0:6.1f}s] {msg}", flush=True)

    text = args.text
    gt = synth_speech(text, speaker=0, seed=0)
    hop = TINY_CODEC.hop
    gt = gt[: (len(gt) // hop) * hop]
    stage(f"synthetic utterance {len(gt) / 24000:.2f}s: {text!r}")

    # ---- 1) codec (optax.adamw's default weight decay, 1e-4, as the root script's optimizer)
    cp = init_codec(gen(0), TINY_CODEC, device=dev)
    tx = adamw(cp, 3e-4, weight_decay=1e-4, clip_norm=1.0)
    oc = tx.init(cp)
    step_c = make_codec_step(TINY_CODEC, CodecTrainConfig(lr=3e-4), tx)
    aud = torch.as_tensor(np.stack([gt, gt])[:, None, :], device=dev)
    closs = torch.zeros(())
    for _ in range(args.codec_steps):
        cp, oc, closs, _ = step_c(cp, oc, aud.clone())
    with torch.no_grad():
        lat_gt = codec_encode(cp, torch.as_tensor(gt[None, None, :], device=dev), TINY_CODEC)[0].cpu().numpy()
        rec = codec_decode(cp, torch.as_tensor(lat_gt[None], device=dev), TINY_CODEC)[0, 0].cpu().numpy()
    floor = mel_distance(gt, rec)
    summary["codec"] = {"steps": args.codec_steps, "loss": round(float(closs), 4),
                        "roundtrip_mel": round(floor, 3), "roundtrip_snr_db": round(snr_db(gt, rec), 2)}
    stage(f"codec: roundtrip mel {floor:.3f} (this is the synthesis floor)")

    # ---- 2) teacher
    T = lat_gt.shape[0]
    tokens = np.asarray([max(1, ord(c) % 150) for c in text], np.int64)
    r = min(8, T)

    def fresh_batch():
        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        return {"phonemes": t(np.tile(tokens[None], (2, 1)), torch.int64),
                "phonemes_lengths": t(np.full((2,), len(tokens)), torch.int32),
                "latents": t(np.tile(lat_gt[None], (2, 1, 1))),
                "latents_lengths": t(np.full((2,), T), torch.int32),
                "ref_latents": t(np.tile(lat_gt[None, :r], (2, 1, 1))),
                "ref_latents_lengths": t(np.full((2,), r), torch.int32)}

    p0 = init_backbone(gen(1), TINY_BACKBONE, device=dev)
    params = ema_init(p0)  # independent copies
    txt_ = adamw(params, 2e-3, clip_norm=1.0)
    ot = txt_.init(params)
    ema = ema_init(params)
    st = make_teacher_step(TINY_BACKBONE, txt_)
    g_draws = gen(2)
    tloss = torch.zeros(())
    for _ in range(args.teacher_steps):
        batch = fresh_batch()
        params, ot, ema, tloss = st(params, ot, ema, batch, teacher_draws(g_draws, batch))
    stage(f"teacher: {args.teacher_steps} steps, final loss {float(tloss):.4f}")

    sampler = make_teacher_sampler(TINY_BACKBONE, num_steps=args.sample_steps, cfg_scale_text=1.0,
                                   cfg_scale_speaker=1.0)

    def sample(p, seed):
        b = fresh_batch()
        noises = torch.randn((args.sample_steps, 1, T, TINY_BACKBONE.latent_dim), generator=gen(seed), device=dev)
        lat = sampler(p, b["ref_latents"][:1], b["ref_latents_lengths"][:1], b["phonemes"][:1],
                      b["phonemes_lengths"][:1], torch.full((1,), T, dtype=torch.int32, device=dev), noises, T)
        with torch.no_grad():
            audio = codec_decode(cp, lat.float(), TINY_CODEC)[0, 0].cpu().numpy()
        return lat[0].cpu().numpy(), audio

    def synth_stats(p):
        mels, lmse = [], []
        for s in (0, 1, 2):
            lat, audio = sample(p, s)
            mels.append(mel_distance(gt, audio))
            lmse.append(float(np.mean((lat - lat_gt) ** 2)))
        return float(np.mean(mels)), float(np.mean(lmse))

    mel_rand, lmse_rand = synth_stats(p0)
    mel_tr, lmse_tr = synth_stats(params)
    summary["tts"] = {"steps": args.teacher_steps, "mel_trained": round(mel_tr, 3), "mel_random": round(mel_rand, 3),
                      "mel_floor": round(floor, 3), "latent_mse_trained": round(lmse_tr, 4),
                      "latent_mse_random": round(lmse_rand, 4)}
    stage(f"TTS: mel {mel_tr:.3f} (random {mel_rand:.3f}, floor {floor:.3f}); "
          f"latent mse {lmse_tr:.4f} vs {lmse_rand:.4f} random")

    if args.samples_out:
        from smalltts_tpu_torch.serving.audio_io import encode_wav

        os.makedirs(args.samples_out, exist_ok=True)
        _, gen_audio = sample(params, 0)
        with open(os.path.join(args.samples_out, "demo_ref.wav"), "wb") as f:
            f.write(encode_wav(gt, 24_000))
        with open(os.path.join(args.samples_out, "demo_gen.wav"), "wb") as f:
            f.write(encode_wav(gen_audio, 24_000))
        with open(os.path.join(args.samples_out, "index.json"), "w") as f:
            json.dump({"samples": [{
                "text": f"synthetic-corpus demo: {args.text!r} (tiny model trained from scratch in-repo; "
                        f"pseudo-speech, not a human voice)",
                "ref": "demo_ref.wav", "gen": "demo_gen.wav",
            }]}, f, indent=1)
        stage(f"samples written to {args.samples_out}")

    # ---- 3) ASR
    asr = init_asr(gen(3), TINY_ASR64, device=dev)
    txa = adamw(asr, 2e-3, weight_decay=1e-4, clip_norm=5.0)
    oa = txa.init(asr)
    step_a = make_asr_step(TINY_ASR64, txa)
    aloss = torch.zeros(())
    for _ in range(args.asr_steps):
        asr, oa, aloss = step_a(asr, oa, fresh_batch())
    decoded = greedy_decode(asr, lat_gt, dev)
    exact = decoded == [int(k) for k in tokens]
    summary["asr"] = {"steps": args.asr_steps, "ctc": round(float(aloss), 4), "greedy_decode_exact": exact}
    stage(f"ASR: CTC {float(aloss):.4f}, greedy decode exact match: {exact}")

    # ---- 4) SV
    teacher_fn, tp = make_teacher_fn(init_sv_teacher(gen(5), TINY_SV_TEACHER, device=dev), TINY_SV_TEACHER)
    sv = init_sv(gen(6), TINY_SV64, device=dev)
    txs = adamw(sv, 1e-3, weight_decay=1e-4, clip_norm=5.0)
    osv = txs.init(sv)
    step_s = make_sv_step(TINY_SV64, TINY_CODEC, txs, teacher_fn)
    before = teacher_cosine(sv, cp, tp, teacher_fn, lat_gt, dev)
    sv_batch = {"latents": torch.as_tensor(lat_gt[None], device=dev),
                "latents_lengths": torch.tensor([T], dtype=torch.int32, device=dev)}
    for _ in range(args.sv_steps):
        sv, osv, _ = step_s(sv, osv, cp, tp, sv_batch)
    after = teacher_cosine(sv, cp, tp, teacher_fn, lat_gt, dev)
    summary["sv"] = {"steps": args.sv_steps, "teacher_cosine_before": round(before, 4),
                     "teacher_cosine_after": round(after, 4)}
    stage(f"SV: teacher cosine {before:.3f} -> {after:.3f}")

    summary["total_seconds"] = round(time.time() - t0, 1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
