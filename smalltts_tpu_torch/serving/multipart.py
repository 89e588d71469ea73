"""Minimal multipart/form-data parser and encoder (stdlib-only) for the
/synthesize contract: fields `audio` (bytes) and `text` (str)
(reference: src/server/src/main.rs:111-120).

The PyTorch port's own copy of smalltts_tpu/serving/multipart.py, with its imports
pointing at smalltts_tpu_torch; it behaves as that module does.
"""

from __future__ import annotations

import re
from typing import Dict


def parse_multipart(body: bytes, content_type: str) -> Dict[str, bytes]:
    """RFC-2046 delimiting: a part's content runs EXACTLY to the next
    CRLF--boundary. The single delimiting CRLF belongs to the framing; any
    other trailing 0x0D/0x0A bytes are part content — a WAV whose last PCM
    byte is 0x0A must come through intact (strip(b"\\r\\n")
    corrupted ~1/128 of binary uploads)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("missing multipart boundary")
    boundary = m.group(1).encode()
    open_delim = b"--" + boundary
    delim = b"\r\n--" + boundary
    start = body.find(open_delim)
    if start < 0:
        raise ValueError("multipart body missing opening boundary")
    rest = body[start + len(open_delim):]
    fields: Dict[str, bytes] = {}
    while rest and not rest.startswith(b"--"):  # b"--" = closing delimiter
        end = rest.find(delim)
        part = rest if end < 0 else rest[:end]
        rest = b"" if end < 0 else rest[end + len(delim):]
        # part = CRLF headers CRLFCRLF content (content bytes untouched)
        blob = part[2:] if part.startswith(b"\r\n") else part.lstrip(b"\r\n")
        if b"\r\n\r\n" not in blob:
            continue
        header_blob, content = blob.split(b"\r\n\r\n", 1)
        name = None
        for line in header_blob.split(b"\r\n"):
            # [;\s] anchor: bare `name=` also matches inside `filename=`,
            # so a part spelled `filename="clip.wav"; name="audio"` (RFC
            # 7578 mandates no attribute order) would parse under the wrong
            # field name without it
            lm = re.search(rb'content-disposition:.*?[;\s]name="([^"]+)"',
                           line, re.I)
            if lm:
                name = lm.group(1).decode()
        if name:
            fields[name] = content
    return fields


def build_multipart(fields: Dict[str, bytes], boundary: str = "SBND"
                    ) -> "tuple[bytes, str]":
    """-> (body, content_type), CRLF-framed to match the strict parser
    above: the one encoder that clients share, so the framing cannot
    drift between them."""
    out = []
    for name, value in fields.items():
        out.append(
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode()
            + (value if isinstance(value, bytes) else str(value).encode())
            + b"\r\n"
        )
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={boundary}"
