"""Phonemize bridge: argv text -> JSON token ids on stdout (port of
scripts/phonemize.py).

    python -m smalltts_tpu_torch.scripts.phonemize <text ...>

Kept for tooling that spawns a phonemizer per request, as the reference's
Rust server does; the port's server phonemizes in-process
(smalltts_tpu_torch.text). Host only: it runs no model, so it takes no
--device.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] in (["-h"], ["--help"]) and len(argv) == 1:
        print(__doc__.strip())
        print("\nusage: phonemize.py <text ...>   # JSON token ids on stdout")
        return 0
    from smalltts_tpu_torch.text import get_token_ids

    print(json.dumps(get_token_ids(" ".join(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
