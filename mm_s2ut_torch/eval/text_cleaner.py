"""Text cleaners for ASR-BLEU normalization.

A copy of ``mm_s2ut/eval/text_cleaner.py`` (the port imports nothing of
the JAX package). A native reimplementation of the reference cleaner stack (SURVEY.md C14;
reference scripts/speech_to_speech_translation/text_cleaner/cleaners.py,
numbers.py): lowercase, abbreviation expansion, number-to-words expansion,
ASCII transliteration, whitespace collapse. The reference depends on
unidecode + inflect; both are reimplemented here (latin transliteration
table; a full cardinal/ordinal/decimal/currency/year number speller) so
the eval chain has no extra dependencies.
"""
from __future__ import annotations

import re
import unicodedata

# -- transliteration (unidecode-lite for latin scripts) -----------------------

_EXTRA = {
    "æ": "ae", "Æ": "AE", "ø": "o", "Ø": "O", "ß": "ss", "þ": "th", "Þ": "Th",
    "ð": "d", "Ð": "D", "œ": "oe", "Œ": "OE", "ł": "l", "Ł": "L",
    "’": "'", "‘": "'", "“": '"', "”": '"', "—": "-", "–": "-", "…": "...",
}


def convert_to_ascii(text: str) -> str:
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _EXTRA:
            out.append(_EXTRA[ch])
            continue
        norm = unicodedata.normalize("NFKD", ch)
        stripped = "".join(c for c in norm if not unicodedata.combining(c))
        out.append(stripped if all(ord(c) < 128 for c in stripped) else "")
    return "".join(out)


# -- abbreviations (reference cleaners.py abbreviation list) ------------------

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for rx, rep in _ABBREVIATIONS:
        text = rx.sub(rep, text)
    return text


# -- number expansion (inflect replacement) -----------------------------------

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
          (100, "hundred")]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[r] if r else "")
    for value, name in _SCALE:
        if n >= value:
            q, r = divmod(n, value)
            head = number_to_words(q) + " " + name
            return head + (" " + number_to_words(r) if r else "")
    return str(n)


_ORD_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n).split()
    last = words[-1]
    if last in _ORD_SPECIAL:
        words[-1] = _ORD_SPECIAL[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


_COMMA_RE = re.compile(r"([0-9][0-9\,]+[0-9])")
_DECIMAL_RE = re.compile(r"([0-9]+\.[0-9]+)")
_POUNDS_RE = re.compile(r"£([0-9\,]*[0-9]+)")
_DOLLARS_RE = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ORDINAL_RE = re.compile(r"([0-9]+)(st|nd|rd|th)")
_NUMBER_RE = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    parts = m.group(1).replace(",", "").split(".")
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1][:2].ljust(2, "0")) if len(parts) > 1 and parts[1] else 0
    out = []
    if dollars:
        out.append(f"{number_to_words(dollars)} dollar{'s' if dollars != 1 else ''}")
    if cents:
        out.append(f"{number_to_words(cents)} cent{'s' if cents != 1 else ''}")
    return ", ".join(out) or "zero dollars"


def _expand_number(m: re.Match) -> str:
    n = int(m.group(0))
    if 1000 < n < 3000:  # year-style reading (reference numbers.py)
        if n == 2000:
            return "two thousand"
        if 2000 < n < 2010:
            return "two thousand " + number_to_words(n % 100)
        if n % 100 == 0:
            return number_to_words(n // 100) + " hundred"
        head, tail = divmod(n, 100)
        tail_w = "oh " + _ONES[tail] if 0 < tail < 10 else (number_to_words(tail) if tail else "")
        return (number_to_words(head) + " " + tail_w).strip()
    return number_to_words(n)


def normalize_numbers(text: str) -> str:
    text = _COMMA_RE.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _POUNDS_RE.sub(
        lambda m: number_to_words(int(m.group(1).replace(",", ""))) + " pounds", text
    )
    text = _DOLLARS_RE.sub(_expand_dollars, text)
    text = _DECIMAL_RE.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ORDINAL_RE.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _NUMBER_RE.sub(_expand_number, text)
    return text


# -- top-level cleaners (reference cleaners.py surface) -----------------------

_WHITESPACE_RE = re.compile(r"\s+")


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE_RE.sub(" ", text).strip()


def lowercase(text: str) -> str:
    return text.lower()


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse (no transliteration)."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration + lowercase + whitespace collapse."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline: transliterate, lowercase, expand numbers and
    abbreviations, collapse whitespace (reference cleaners.py:80-87)."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)
