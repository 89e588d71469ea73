"""Self-contained English number spelling (replaces the `inflect` dependency).

Covers what the reference normalizer actually uses
(reference: src/smalltts/data/phonemization/normalizer.py:42,61-133):
cardinals, ordinal words, and grouped ("nineteen seventy-five") year reading.

The PyTorch port's own copy of smalltts_tpu/text/numbers.py, with its imports
pointing at smalltts_tpu_torch; it behaves as that module does.
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = ["", "thousand", "million", "billion", "trillion", "quadrillion",
           "quintillion", "sextillion", "septillion", "octillion",
           "nonillion", "decillion"]

_ORDINAL_MAP = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _under_1000(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        parts.append(_under_100(rest))
    return " ".join(parts) if parts else "zero"


def number_to_words(n: int) -> str:
    """Cardinal spelling without 'and' (inflect andword='' behavior).

    Beyond the named scales (decillion = 1e33) the number is read digit by
    digit — unlike a silent truncation, every digit reaches the listener
    (1e18 used to spell as '' when the scale table ran out)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n == 0:
        return "zero"
    if n >= 1000 ** len(_SCALES):
        return " ".join(_ONES[int(d)] for d in str(n))
    chunks = []
    i = 0
    while n > 0:
        n, chunk = divmod(n, 1000)
        if chunk:
            word = _under_1000(chunk)
            if _SCALES[i]:
                word += " " + _SCALES[i]
            chunks.append(word)
        i += 1
    return " ".join(reversed(chunks))


def number_to_words_grouped(n: int, zero: str = "oh") -> str:
    """Two-digit grouped reading for year-like numbers: 1975 -> 'nineteen seventy-five'."""
    s = str(n)
    if len(s) % 2 == 1:
        s = "0" + s
    parts = []
    for i in range(0, len(s), 2):
        pair = int(s[i : i + 2])
        if pair == 0:
            parts.append("hundred" if i else zero)
        elif pair < 10 and i > 0:
            parts.append(zero + " " + _ONES[pair])
        else:
            parts.append(_under_100(pair))
    return " ".join(parts)


def ordinal_word(word: str) -> str:
    """Cardinal words -> ordinal words: 'twenty-one' -> 'twenty-first'."""
    tokens = word.rsplit(" ", 1)
    head, last = (tokens[0] + " ", tokens[1]) if len(tokens) == 2 else ("", tokens[0])
    if "-" in last:
        pre, final = last.rsplit("-", 1)
        return head + pre + "-" + ordinal_word(final)
    if last in _ORDINAL_MAP:
        return head + _ORDINAL_MAP[last]
    if last.endswith("y"):
        return head + last[:-1] + "ieth"
    return head + last + "th"


def number_to_ordinal_words(n: int) -> str:
    return ordinal_word(number_to_words(n))
