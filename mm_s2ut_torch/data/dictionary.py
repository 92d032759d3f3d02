"""Unit vocabulary with the fairseq special-token layout (numpy only).

A copy of ``mm_s2ut/data/dictionary.py``: ids ``<s>=0, <pad>=1, </s>=2,
<unk>=3``, then unit ``k`` at id ``k + 4``, then any ``<lang:xx>`` tags;
``Dictionary.load`` reads a fairseq ``dict.txt``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np


class Dictionary:
    def __init__(self, bos: str = "<s>", pad: str = "<pad>",
                 eos: str = "</s>", unk: str = "<unk>"):
        self.symbols: List[str] = []
        self.indices: dict[str, int] = {}
        self.unk_word = unk
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        self.nspecial = len(self.symbols)

    def add_symbol(self, word: str) -> int:
        if word in self.indices:
            return self.indices[word]
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        return idx

    @classmethod
    def load(cls, path: str | Path) -> "Dictionary":
        """A fairseq-format ``dict.txt`` (one "symbol count" per line)."""
        d = cls()
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if line:
                d.add_symbol(line.rsplit(" ", 1)[0])
        return d

    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        return self.symbols[idx] if 0 <= idx < len(self.symbols) else self.unk_word

    def index(self, word: str) -> int:
        return self.indices.get(word, self.unk_index)

    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def encode_line(self, line: str, append_eos: bool = True) -> np.ndarray:
        ids = [self.index(w) for w in line.split()]
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int32)

    def string(self, ids: Sequence[int], strip_special: bool = True) -> str:
        special = {self.bos_index, self.pad_index, self.eos_index}
        return " ".join(
            self[int(i)] for i in ids
            if not (strip_special and int(i) in special)
        )


class UnitDictionary(Dictionary):
    """Dictionary over discrete acoustic units "0".."K-1" (unit k at id
    k+4), then the given lang tags."""

    def __init__(self, n_units: int = 1000, lang_tags: Optional[Iterable[str]] = None):
        super().__init__()
        self.n_units = n_units
        for k in range(n_units):
            self.add_symbol(str(k))
        self.lang_tags = {tag: self.add_symbol(tag) for tag in lang_tags or ()}

    def ids_to_units(self, ids: Sequence[int]) -> np.ndarray:
        """vocab id -> unit index, dropping specials/lang-tags."""
        ids = np.asarray(ids, dtype=np.int32)
        mask = (ids >= self.nspecial) & (ids < self.nspecial + self.n_units)
        return ids[mask] - self.nspecial
