"""English text normalizer: abbreviation + number expansion.

Behavioral parity with the reference normalizer (reference:
src/smalltts/data/phonemization/normalizer.py:8-149, itself adapted from
ZipVoice): the same abbreviation table and the same ordered number rules
(comma stripping, pounds, dollars, fractions, decimals, percents, ordinals,
plain numbers with year-style grouped reading for 1000..3000), implemented on
our own number speller instead of `inflect`.

The PyTorch port's own copy of smalltts_tpu/text/normalizer.py, with its imports
pointing at smalltts_tpu_torch; it behaves as that module does.
"""

from __future__ import annotations

import re

from smalltts_tpu_torch.text.numbers import (
    number_to_ordinal_words,
    number_to_words,
    number_to_words_grouped,
)

_ABBREVIATIONS = [
    ("mrs", "misess"),
    ("mr", "mister"),
    ("dr", "doctor"),
    ("st", "saint"),
    ("co", "company"),
    ("jr", "junior"),
    ("maj", "major"),
    ("gen", "general"),
    ("drs", "doctors"),
    ("rev", "reverend"),
    ("lt", "lieutenant"),
    ("hon", "honorable"),
    ("sgt", "sergeant"),
    ("capt", "captain"),
    ("esq", "esquire"),
    ("ltd", "limited"),
    ("col", "colonel"),
    ("ft", "fort"),
    ("etc", "et cetera"),
    ("btw", "by the way"),
]


class EnglishTextNormalizer:
    def __init__(self) -> None:
        # \b%s\b with NO trailing dot, exactly like the reference
        # (normalizer.py:17): bare "ft" expands to "fort" and "Dr." keeps
        # its period — quirky, but parity-pinned; do not "fix" to \b%s\.
        # (the unused _whitespace_re below is likewise reference-mirrored)
        self._abbreviations = [
            (re.compile(r"\b%s\b" % abbr, re.IGNORECASE), replacement)
            for abbr, replacement in _ABBREVIATIONS
        ]
        self._comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
        self._decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
        self._percent_number_re = re.compile(r"([0-9\.\,]*[0-9]+%)")
        self._pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
        self._dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
        self._fraction_re = re.compile(r"([0-9]+)/([0-9]+)")
        self._ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
        self._number_re = re.compile(r"[0-9]+")
        self._whitespace_re = re.compile(r"\s+")

    def normalize(self, text: str) -> str:
        text = self.expand_abbreviations(text)
        text = self.normalize_numbers(text)
        return text

    # ------------------------------------------------------------- helpers

    def expand_abbreviations(self, text: str) -> str:
        for regex, replacement in self._abbreviations:
            text = regex.sub(replacement, text)
        return text

    def _fraction_to_words(self, numerator: int, denominator: int) -> str:
        if numerator == 1 and denominator == 2:
            return " one half "
        if numerator == 1 and denominator == 4:
            return " one quarter "
        if denominator == 2:
            return f" {number_to_words(numerator)} halves "
        if denominator == 4:
            return f" {number_to_words(numerator)} quarters "
        return f" {number_to_words(numerator)} {number_to_ordinal_words(denominator)} "

    def _expand_dollars(self, m: re.Match) -> str:
        match = m.group(1)
        parts = match.split(".")
        if len(parts) > 2:
            return " " + match + " dollars "
        dollars = int(parts[0]) if parts[0] else 0
        cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        if dollars and cents:
            dollar_unit = "dollar" if dollars == 1 else "dollars"
            cent_unit = "cent" if cents == 1 else "cents"
            return f" {dollars} {dollar_unit}, {cents} {cent_unit} "
        if dollars:
            return f" {dollars} {'dollar' if dollars == 1 else 'dollars'} "
        if cents:
            return f" {cents} {'cent' if cents == 1 else 'cents'} "
        return " zero dollars "

    def _expand_number(self, m: re.Match) -> str:
        num = int(m.group(0))
        if 1000 < num < 3000:
            if num == 2000:
                return " two thousand "
            if 2000 < num < 2010:
                return " two thousand " + number_to_words(num % 100) + " "
            if num % 100 == 0:
                return " " + number_to_words(num // 100) + " hundred "
            return " " + number_to_words_grouped(num) + " "
        return " " + number_to_words(num) + " "

    def normalize_numbers(self, text: str) -> str:
        text = self._comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
        text = self._pounds_re.sub(r"\1 pounds", text)
        text = self._dollars_re.sub(self._expand_dollars, text)
        text = self._fraction_re.sub(
            lambda m: self._fraction_to_words(int(m.group(1)), int(m.group(2))), text
        )
        text = self._decimal_number_re.sub(
            lambda m: m.group(1).replace(".", " point "), text
        )
        text = self._percent_number_re.sub(
            lambda m: m.group(1).replace("%", " percent "), text
        )
        text = self._ordinal_re.sub(
            lambda m: " " + number_to_ordinal_words(int(m.group(0)[:-2])) + " ", text
        )
        text = self._number_re.sub(self._expand_number, text)
        return text
