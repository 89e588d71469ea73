"""x402 client smoke test: pay a server and save output.wav (port of
scripts/test_x402.py).

    SERVER_URL=http://localhost:3000 [PRIVATE_KEY=hex] [TEXT=...] [DURATION=3.0] [REF_WAV=ref.wav] \\
        python -m smalltts_tpu_torch.scripts.test_x402

Reads SERVER_URL, TEXT, DURATION, REF_WAV and PRIVATE_KEY from the
environment, POSTs the reference audio (REF_WAV, else a 2 s 220 Hz sine)
and the text as multipart to /synthesize, answers a 402 challenge, and
writes the returned wav to output.wav. With PRIVATE_KEY (hex) the client
signs an EIP-3009 TransferWithAuthorization (X402Gate.sign_payment),
which `--payments local` servers verify in-process and facilitator
deployments settle on-chain; without it an unsigned echo envelope is sent,
which only `--payments trust` servers accept. A client of the HTTP API: it
runs no model, so it takes no --device.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import urllib.error
import urllib.request
import uuid

import numpy as np


def make_ref_wav() -> bytes:
    from smalltts_tpu_torch.serving.audio_io import encode_wav

    t = np.arange(2 * 24_000) / 24_000
    return encode_wav(0.4 * np.sin(2 * np.pi * 220 * t), 24_000)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] in (["-h"], ["--help"]):
        # an env-driven client: help dials nothing
        print(__doc__.strip())
        print("\nusage: SERVER_URL=... [PRIVATE_KEY=...] [TEXT=...] "
              "[DURATION=...] [REF_WAV=...] python -m smalltts_tpu_torch.scripts.test_x402")
        return 0
    from smalltts_tpu_torch.serving.multipart import build_multipart

    server = os.environ.get("SERVER_URL", "http://localhost:3000")
    text = os.environ.get("TEXT", "Hello from the x402 smoke test.")
    duration = os.environ.get("DURATION", "3.0")
    ref_path = os.environ.get("REF_WAV")

    if ref_path:
        with open(ref_path, "rb") as f:
            audio = f.read()
    else:
        audio = make_ref_wav()
    body, ctype = build_multipart({"audio": audio, "text": text}, boundary=uuid.uuid4().hex)
    url = f"{server}/synthesize?duration={duration}"
    headers = {"content-type": ctype}

    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        resp = urllib.request.urlopen(req, timeout=120)
    except urllib.error.HTTPError as e:
        if e.code != 402:
            raise
        challenge = json.loads(base64.b64decode(e.headers["payment-required"]))
        accept = challenge["accepts"][0]
        print(f"402: {accept['maxAmountRequired']} units to {accept['payTo']} on {accept['network']}")
        priv = os.environ.get("PRIVATE_KEY")
        if priv:
            # a signed EIP-3009 authorization from the wallet key
            from smalltts_tpu_torch.serving.x402 import X402Config, X402Gate

            payment = X402Gate(X402Config(mode="local")).sign_payment(int(priv, 16), accept)
            print("signed EIP-3009 payment from key in PRIVATE_KEY")
        else:
            # an echo envelope: trust-mode servers accept it, real deployments verify a signature
            payment = base64.b64encode(json.dumps({"x402Version": 1, "scheme": accept["scheme"],
                                                   "network": accept["network"], "payload": {}}).encode()).decode()
        req = urllib.request.Request(url, data=body, headers={**headers, "x-payment": payment})
        resp = urllib.request.urlopen(req, timeout=120)

    wav = resp.read()
    assert resp.headers.get("content-type") == "audio/wav", resp.headers
    with open("output.wav", "wb") as f:
        f.write(wav)
    print(f"wrote output.wav ({len(wav)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
