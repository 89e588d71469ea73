"""The pretrained waveform speaker-verification teacher, speechbrain's
spkrec-ecapa-voxceleb equivalent (port of smalltts_tpu/models/sv_teacher.py):
the target of the SV trainer (train/sv_train.py) when its checkpoint is
given.

- `fbank`: 80 log-mel bands as speechbrain's Fbank computes them: a
  centred, zero-padded STFT (25 ms periodic Hamming window, 10 ms hop, n_fft
  400), the power spectrum, HTK mel triangles, 10 log10 with amin 1e-10 and
  a per-utterance top_db 80 floor (over frames and bands);
- `mean_norm`: the per-utterance mean over valid frames subtracted
  (InputNormalization, sentence, no std);
- `resample_24k_to_16k`: the polyphase Kaiser-windowed sinc (up 2, down 3)
  as the JAX package's dilated convolution: zero-stuffed to 2T - 1 samples,
  padded k // 2 each side, stride 3;
- `VOXCELEB_ECAPA` over models/sv.py: input 80, channels 1024 x 4 + 3072,
  kernels 5/3/3/3/1, dilations 1/2/3/4/1, attention 128, res2net scale 8,
  SE 128, embedding 192;
- `convert_speechbrain_teacher`: the published EncoderClassifier state dict
  (with or without the `embedding_model.` prefix) -> the JAX-layout tree;
  `load_teacher` -> the port's params.

Runs in fp32; the resampler's and the ECAPA's convolutions with cuDNN's
TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from smalltts_tpu_torch.models.sv import SVConfig, init_sv, sv_forward
from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.utils.torch_convert import convert_sv_state_dict

VOXCELEB_ECAPA = SVConfig(
    input_dim=80,
    emb_dim=192,
    channels=(1024, 1024, 1024, 1024, 3072),
    kernel_sizes=(5, 3, 3, 3, 1),
    dilations=(1, 2, 3, 4, 1),
    attention_channels=128,
    res2net_scale=8,
    se_channels=128,
)


@dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16_000
    n_fft: int = 400
    win_length: int = 400  # 25 ms
    hop_length: int = 160  # 10 ms
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8_000.0
    top_db: float = 80.0
    amin: float = 1e-10


def _mel_filters(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank, HTK style with no slaney normalization:
    (n_fft // 2 + 1, n_mels)."""
    n_freqs = cfg.n_fft // 2 + 1
    all_freqs = np.linspace(0, cfg.sample_rate / 2, n_freqs)
    mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)  # noqa: E731
    inv_mel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)  # noqa: E731
    pts = inv_mel(np.linspace(mel(cfg.f_min), mel(cfg.f_max), cfg.n_mels + 2))
    f_diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def fbank(audio: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """(B, T) 16 kHz waveform -> (B, frames, n_mels) log-mel features,
    frames = 1 + T // hop."""
    pad = cfg.n_fft // 2
    frames = F.pad(audio, (pad, pad)).unfold(-1, cfg.n_fft, cfg.hop_length)  # (B, F, n_fft)
    window = torch.from_numpy(np.hamming(cfg.win_length + 1)[:-1].astype(np.float32)).to(audio.device)  # periodic
    spec = torch.fft.rfft(frames * window, n=cfg.n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ torch.from_numpy(_mel_filters(cfg)).to(audio.device)
    db = 10.0 * torch.log10(torch.clamp_min(mel, cfg.amin))
    floor = db.amax(dim=(1, 2), keepdim=True) - cfg.top_db
    return torch.maximum(db, floor)


def mean_norm(feats: torch.Tensor, lengths: torch.Tensor = None) -> torch.Tensor:
    """The per-utterance mean over time subtracted; over the first
    `lengths` frames where given."""
    if lengths is None:
        return feats - feats.mean(dim=1, keepdim=True)
    mask = (torch.arange(feats.shape[1], device=feats.device)[None, :] < lengths[:, None])[..., None].to(feats.dtype)
    mean = (feats * mask).sum(dim=1, keepdim=True) / torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
    return feats - mean


def _polyphase_kernel(up: int, down: int, width: int = 32, beta: float = 14.769656) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for rational resampling (gain `up`)."""
    cutoff = 1.0 / max(up, down)
    half = width * max(up, down)
    n = np.arange(-half, half + 1)
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(2 * half + 1, beta) * up
    return h.astype(np.float32)


def resample_24k_to_16k(audio: torch.Tensor) -> torch.Tensor:
    """(B, 1, T) 24 kHz -> (B, 1, (2T - 2) // 3 + 1) 16 kHz: JAX's
    conv_general_dilated with lhs_dilation 2, stride 3, padding k // 2."""
    h = torch.from_numpy(_polyphase_kernel(2, 3)).to(audio.device, audio.dtype)
    b, c, t = audio.shape
    stuffed = audio.new_zeros((b, c, 2 * t - 1))
    stuffed[..., ::2] = audio
    with nn.no_tf32():
        return F.conv1d(stuffed, h[None, None, :], stride=3, padding=h.shape[0] // 2)


def init_sv_teacher(gen, cfg: SVConfig = VOXCELEB_ECAPA, dtype=torch.float32, device="cpu"):
    return init_sv(gen, cfg, dtype, device)


def sv_teacher_embed(params, audio_16k: torch.Tensor, lengths: torch.Tensor = None, cfg: SVConfig = VOXCELEB_ECAPA,
                     fbank_cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """(B, 1, T) 16 kHz waveform in [-1, 1], lengths (B,) samples -> (B,
    emb_dim) speaker embedding, unnormalized (encode_batch(normalize=False))."""
    wav = audio_16k[:, 0, :]
    feats = fbank(wav, fbank_cfg)
    if lengths is None:
        frame_lengths = torch.full((wav.shape[0],), feats.shape[1], dtype=torch.int32, device=wav.device)
    else:
        frame_lengths = torch.clamp_max(lengths // fbank_cfg.hop_length + 1, feats.shape[1]).to(torch.int32)
    emb, _ = sv_forward(params, cfg, mean_norm(feats, frame_lengths), frame_lengths, train=False)
    return emb


def convert_speechbrain_teacher(sd) -> dict:
    """speechbrain EncoderClassifier / embedding_model.ckpt state dict of
    numpy arrays -> the JAX-layout tree (strips the `embedding_model.`
    prefix where present)."""
    if any(k.startswith("embedding_model.") for k in sd):
        sd = {k[len("embedding_model."):]: v for k, v in sd.items() if k.startswith("embedding_model.")}
    return convert_sv_state_dict(sd, res2net_scale=VOXCELEB_ECAPA.res2net_scale)


def make_teacher_fn(params, cfg: SVConfig = VOXCELEB_ECAPA):
    """-> (teacher_fn(teacher_params, audio_24k, lengths=None), params): the
    codec's 24 kHz (B, 1, T) audio resampled to 16 kHz, lengths (B, valid
    samples at 24 kHz) scaled to 16 kHz, -> (B, emb_dim) embeddings."""

    def teacher_fn(tp, audio_24k: torch.Tensor, lengths=None) -> torch.Tensor:
        lengths_16k = None if lengths is None else (lengths * 2) // 3
        return sv_teacher_embed(tp, resample_24k_to_16k(audio_24k), lengths_16k, cfg=cfg)

    return teacher_fn, params


def load_teacher(path: str, device="cpu"):
    """The port's params of VOXCELEB_ECAPA on `device` from a speechbrain
    embedding_model.ckpt (torch) or an npz in the JAX package's layout."""
    from smalltts_tpu_torch.utils.checkpoint import load_pytree, map_pytree
    from smalltts_tpu_torch.utils.convert import params_from_jax
    from smalltts_tpu_torch.utils.torch_convert import state_dict_to_numpy

    if path.endswith(".npz"):
        tree = load_pytree(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        tree = convert_speechbrain_teacher(state_dict_to_numpy(sd))
    return map_pytree(lambda t: t.to(device), params_from_jax(tree, VOXCELEB_ECAPA))
