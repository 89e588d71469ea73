"""ImportedSmallTTS: the reference's published inference graphs (port of
smalltts_tpu/onnxjax/pipeline.py).

The reference distributes its trained model as ONNX graphs,
assets/dmd/{condition_encoder,denoiser}.onnx + assets/codec/decoder.onnx.
This class runs those files through the interpreter with the reference
client's semantics:

* seq_len = max(1, int(dur * SR / HOP)): the Python client truncates, and
  so does this class (SmallTTS follows the Rust server's ceil);
* RoPE freqs come from the host (`_rope_freqs`);
* x_pred starts at zeros; x_t = alpha*x_pred + sigma*fresh_noise; no CFG.

Positional I/O contract:
  cond_encoder(ref[1,T,64] f32, ref_len[1] i64, phonemes[1,P] i64,
               phonemes_mask[1,P] bool)
      -> (k_ref, v_ref, ref_mask, k_text, v_text)   # rank-5 KV stacks
  denoiser(x_t, mask, t[1] f32, k_ref, v_ref, ref_mask, k_text, v_text,
           phonemes_mask, rope[1,S,64] f32) -> velocity
  codec_decoder(latents) -> audio

Every graph runs in fp32 with TF32 off. The noise comes from a seeded
torch.Generator, or from `noises=` (the JAX package's key stream cannot be
matched).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from smalltts_tpu_torch.onnxtorch.interp import OnnxFunction
from smalltts_tpu_torch.onnxtorch.proto import load_model
from smalltts_tpu_torch.ops.schedule import get_alpha_sigma
from smalltts_tpu_torch.utils.transfer import resolve_device

SAMPLE_RATE = 24_000
HOP_SIZE = 3_200
NUM_STEPS = 4


def _rope_freqs(seq_len: int, dim: int = 64) -> np.ndarray:
    """Host-side RoPE table (1, seq_len, dim): each frequency twice, interleaved."""
    inv_freq = 1.0 / (1e4 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(seq_len, dtype=np.float32).reshape(1, -1)
    freqs = np.einsum("bi,j->bij", t, inv_freq)
    return np.stack([freqs, freqs], axis=-1).reshape(1, seq_len, dim)


class ImportedSmallTTS:
    """The reference's published ONNX graphs as one synthesizer on `device`
    (None means the card; `device="cpu"` runs on the CPU)."""

    def __init__(self, cond_encoder_path: Optional[str] = None, denoiser_path: Optional[str] = None,
                 codec_decoder_path: Optional[str] = None, codec_encoder_path: Optional[str] = None,
                 num_steps: int = NUM_STEPS, seed: int = 0, device=None) -> None:
        self.device = resolve_device(device)
        # None -> the published layout under $SMALLTTS_ASSETS, resolved now
        root = os.environ.get("SMALLTTS_ASSETS", "assets")
        cond_encoder_path = cond_encoder_path or os.path.join(root, "dmd", "condition_encoder.onnx")
        denoiser_path = denoiser_path or os.path.join(root, "dmd", "denoiser.onnx")
        codec_decoder_path = codec_decoder_path or os.path.join(root, "codec", "decoder.onnx")

        def load(path):
            # external-data initializers resolve against the model's directory
            return OnnxFunction(load_model(path), base_dir=os.path.dirname(path) or ".")

        self.cond_enc = load(cond_encoder_path)
        self.denoiser = load(denoiser_path)
        self.codec_dec = load(codec_decoder_path)
        self.codec_enc = load(codec_encoder_path) if codec_encoder_path else None
        fns = {"cond": self.cond_enc, "den": self.denoiser, "dec": self.codec_dec, "enc": self.codec_enc}
        self.params = {k: {n: t.to(self.device) for n, t in fn.params.items()}
                       for k, fn in fns.items() if fn is not None}
        self.num_steps = num_steps
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype)

    def _synthesize(self, ref, ref_len, phonemes, phonemes_mask, noises, seq_len: int):
        p = self.params
        k_ref, v_ref, ref_mask, k_text, v_text = self.cond_enc(p["cond"], ref, ref_len, phonemes, phonemes_mask)
        rope = self._tensor(_rope_freqs(seq_len), torch.float32)
        mask = torch.ones((1, seq_len), dtype=torch.bool, device=self.device)
        ts = torch.linspace(1.0, 0.0, self.num_steps, dtype=torch.float32, device=self.device)
        alphas, sigmas = get_alpha_sigma(ts)
        x_pred = torch.zeros((1, seq_len, ref.shape[-1]), dtype=torch.float32, device=self.device)
        for i in range(self.num_steps):
            x_t = alphas[i] * x_pred + sigmas[i] * noises[i]
            velocity = self.denoiser(p["den"], x_t, mask, ts[i:i + 1], k_ref, v_ref, ref_mask, k_text, v_text,
                                     phonemes_mask, rope)
            if isinstance(velocity, tuple):
                velocity = velocity[0]
            x_pred = alphas[i] * x_t - sigmas[i] * velocity
        audio = self.codec_dec(p["dec"], x_pred)
        return audio[0] if isinstance(audio, tuple) else audio

    def synthesize(self, ref_latents: np.ndarray, phoneme_ids: Sequence[int], duration_sec: float,
                   noises: Optional[np.ndarray] = None) -> np.ndarray:
        """-> (1, samples) float32 at 24 kHz. `noises` (steps, 1, S, 64)
        replaces the generator's noise."""
        seq_len = max(1, int(duration_sec * SAMPLE_RATE / HOP_SIZE))
        ref = np.asarray(ref_latents, np.float32)[None]
        phonemes = np.array([list(phoneme_ids)], np.int64)
        if noises is not None and np.shape(noises)[0] != self.num_steps:
            raise ValueError(f"noises has {np.shape(noises)[0]} steps, num_steps={self.num_steps}")
        with torch.inference_mode():
            if noises is None:
                noises = torch.randn((self.num_steps, 1, seq_len, ref.shape[-1]), generator=self._gen,
                                     device=self.device, dtype=torch.float32)
            else:
                noises = self._tensor(noises, torch.float32)
            audio = self._synthesize(self._tensor(ref, torch.float32),
                                     self._tensor([ref.shape[1]], torch.int64),
                                     self._tensor(phonemes, torch.int64),
                                     torch.ones(phonemes.shape, dtype=torch.bool, device=self.device),
                                     noises, seq_len)
            return audio.cpu().numpy()[0]

    def encode_reference(self, audio_24k: np.ndarray) -> np.ndarray:
        """(T,) waveform -> (T', 64) latents via the imported encoder."""
        if self.codec_enc is None:
            raise ValueError("built without codec_encoder_path")
        pad = (-len(audio_24k)) % HOP_SIZE
        wav = np.pad(np.asarray(audio_24k, np.float32), (0, pad))[None, None]
        with torch.inference_mode():
            out = self.codec_enc(self.params["enc"], self._tensor(wav, torch.float32))
            return out.cpu().numpy()[0]


def assets_present(root: str = None) -> bool:
    if root is None:
        root = os.environ.get("SMALLTTS_ASSETS", "assets")
    return all(os.path.isfile(os.path.join(root, p))
               for p in ("dmd/condition_encoder.onnx", "dmd/denoiser.onnx", "codec/decoder.onnx"))
