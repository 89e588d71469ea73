"""Phoneme vocabulary: 197 symbols, id 0 = pad / CTC blank, `phoneme_len` = 198.

The symbol inventory is the model's interface contract and MUST match the
reference token ids exactly (reference: src/smalltts/data/phonemization/
phonemes.py:10-54): 16 punctuation marks, 52 ASCII letters, 109 IPA symbols,
and 23 bracketed non-verbal sound-event tokens such as `[laughter]`, each
repeated NV_REPEAT=4 times when tokenized. These strings are vocabulary
*data*, not code — changing a single character silently breaks checkpoint
compatibility.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# NB: the reference literal repeats the straight quote 0x22 three times; after
# dedup the inventory is 13 punctuation chars + space -> space is token id 14.
_PUNCT = ';:,.!?¡¿—…"«» '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢ"
    "ǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
SED_LABELS = [
    "babble",
    "boo",
    "burp",
    "chant",
    "cheer",
    "cough",
    "cry",
    "gargle",
    "gasp",
    "groan",
    "grunt",
    "hiccup",
    "hum",
    "laughter",
    "moan",
    "shout",
    "sigh",
    "sing",
    "sneeze",
    "sniff",
    "snore",
    "whisper",
    "whistle",
]

NV_REPEAT = 4

_syms: List[str] = []
_seen = set()
for _ch in _PUNCT + _LETTERS + _LETTERS_IPA:
    if _ch not in _seen:
        _seen.add(_ch)
        _syms.append(_ch)
for _label in SED_LABELS:
    _sym = f"[{_label}]"
    if _sym not in _seen:
        _seen.add(_sym)
        _syms.append(_sym)

p2idx: Dict[str, int] = {ch: i + 1 for i, ch in enumerate(_syms)}
idx2p: Dict[int, str] = {v: k for k, v in p2idx.items()}
phoneme_len: int = len(p2idx) + 1  # 198: +1 for pad / CTC blank at id 0
phonemes: List[str] = _syms


def get_sed_event_id(label: str) -> Optional[int]:
    """Token id for a bracketed sound-event label, or None if unknown."""
    low = label.lower()
    return p2idx.get(f"[{low}]") if low in SED_LABELS else None


def decode_token_ids(token_ids) -> str:
    return "".join(idx2p.get(int(t), "") for t in token_ids)
