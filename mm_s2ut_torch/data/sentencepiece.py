"""Dependency-free SentencePiece: .model reader, encoder, decoder.

A copy of ``mm_s2ut/data/sentencepiece.py`` (numpy-free, standard library
only): :func:`load_model` parses a ``.model`` protobuf (pieces, scores,
types, the trainer's model type) with a minimal wire-format walker;
:class:`SentencePieceProcessor` encodes text into pieces (Viterbi
max-score segmentation for unigram, best-scored-pair merging for BPE) and
decodes pieces into text (``▁`` → space); :func:`build_model` serializes
a model from (piece, score) pairs, so tests and data preparation can make
one without the C++ trainer. Normalization: the default
``add_dummy_prefix`` and space → ``▁`` (no NFKC). The S2T dataset
tokenizes transcripts through :func:`build_bpe_tokenizer` and
:func:`apply_pre_tokenizer`.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

WORD_SEP = "▁"  # ▁

# SentencePiece.Type enum values (sentencepiece_model.proto).
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2


# ---------------------------------------------------------------------------
# protobuf wire format (read/write just what the model file uses)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _walk(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            val, i = buf[i:i + 8], i + 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wt == 5:  # 32-bit
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, val


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fno: int, wt: int, payload: bytes) -> bytes:
    return _varint((fno << 3) | wt) + payload


@dataclass
class SentencePieceModel:
    pieces: List[str]
    scores: List[float]
    types: List[int]
    model_type: int = UNIGRAM
    unk_id: int = 0
    index: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.index:
            self.index = {p: i for i, p in enumerate(self.pieces)}
        for i, t in enumerate(self.types):
            if t == UNKNOWN:
                self.unk_id = i
                break


def load_model(path: str | Path) -> SentencePieceModel:
    """Parse a SentencePiece ``.model`` protobuf."""
    buf = Path(path).read_bytes()
    pieces: List[str] = []
    scores: List[float] = []
    types: List[int] = []
    model_type = UNIGRAM
    for fno, wt, val in _walk(buf):
        if fno == 1 and wt == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _walk(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
        elif fno == 2 and wt == 2:  # TrainerSpec
            for f2, w2, v2 in _walk(val):
                if f2 == 3 and w2 == 0:  # model_type
                    model_type = v2
    return SentencePieceModel(pieces, scores, types, model_type)


def build_model(
    pieces: Sequence[Tuple[str, float]],
    model_type: int = UNIGRAM,
    specials: Sequence[str] = ("<unk>", "<s>", "</s>"),
) -> bytes:
    """Serialize a ModelProto from (piece, score) pairs. ``specials`` go
    first as (UNKNOWN, CONTROL, CONTROL) with score 0 — sentencepiece's
    default layout."""
    out = bytearray()

    def sp_entry(piece: str, score: float, ptype: int) -> bytes:
        body = _field(1, 2, _varint(len(piece.encode())) + piece.encode())
        body += _field(2, 5, struct.pack("<f", score))
        body += _field(3, 0, _varint(ptype))
        return _field(1, 2, _varint(len(body)) + body)

    for i, s in enumerate(specials):
        out += sp_entry(s, 0.0, UNKNOWN if i == 0 else CONTROL)
    for piece, score in pieces:
        out += sp_entry(piece, score, NORMAL)
    trainer = _field(3, 0, _varint(model_type))
    out += _field(2, 2, _varint(len(trainer)) + trainer)
    return bytes(out)


# ---------------------------------------------------------------------------
# encoding / decoding
# ---------------------------------------------------------------------------


class SentencePieceProcessor:
    """Runtime encode/decode over a parsed model."""

    def __init__(self, model: SentencePieceModel):
        self.m = model
        # Only NORMAL/USER_DEFINED pieces participate in segmentation.
        self.seg_scores = {
            p: s for p, s, t in zip(model.pieces, model.scores, model.types)
            if t in (NORMAL, USER_DEFINED)
        }
        self.unk_penalty = min(self.seg_scores.values(), default=0.0) - 10.0

    @classmethod
    def load(cls, path: str | Path) -> "SentencePieceProcessor":
        return cls(load_model(path))

    def _normalize(self, text: str) -> str:
        text = " ".join(text.split())  # collapse whitespace
        return WORD_SEP + text.replace(" ", WORD_SEP)

    def encode(self, text: str) -> List[str]:
        s = self._normalize(text)
        if not s:
            return []
        if self.m.model_type == BPE:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    def encode_ids(self, text: str) -> List[int]:
        idx = self.m.index
        return [idx.get(p, self.m.unk_id) for p in self.encode(text)]

    def decode(self, pieces: Sequence[str]) -> str:
        return "".join(pieces).replace(WORD_SEP, " ").strip()

    # -- unigram: Viterbi max total score over the piece lattice ----------

    def _encode_unigram(self, s: str) -> List[str]:
        n = len(s)
        max_piece = max((len(p) for p in self.seg_scores), default=1)
        best = [float("-inf")] * (n + 1)
        back: List[Optional[int]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            # single-char fallback (unk) keeps the lattice connected
            end_limit = min(n, i + max_piece)
            matched_single = False
            for j in range(i + 1, end_limit + 1):
                sub = s[i:j]
                sc = self.seg_scores.get(sub)
                if sc is None:
                    continue
                if j == i + 1:
                    matched_single = True
                if best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = i
            if not matched_single:
                sc = best[i] + self.unk_penalty
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = i
        out: List[str] = []
        j = n
        while j > 0:
            i = back[j]
            assert i is not None
            out.append(s[i:j])
            j = i
        return out[::-1]

    # -- BPE: repeatedly merge the best-scored adjacent pair --------------

    def _encode_bpe(self, s: str) -> List[str]:
        sym = list(s)
        while True:
            best_score, best_i = float("-inf"), -1
            for i in range(len(sym) - 1):
                sc = self.seg_scores.get(sym[i] + sym[i + 1])
                if sc is not None and sc > best_score:
                    best_score, best_i = sc, i
            if best_i < 0:
                return sym
            sym[best_i:best_i + 2] = [sym[best_i] + sym[best_i + 1]]


# ---------------------------------------------------------------------------
# fairseq-style pre-tokenizer + bpe wrapper (S2T data-config surface)
# ---------------------------------------------------------------------------


def build_bpe_tokenizer(cfg: Optional[Dict]) -> Optional[SentencePieceProcessor]:
    """fairseq S2TDataConfig ``bpe_tokenizer`` dict →
    processor (``{bpe: sentencepiece, sentencepiece_model: path}``)."""
    if not cfg:
        return None
    kind = cfg.get("bpe")
    if kind in (None, "", "none"):
        return None
    if kind != "sentencepiece":
        raise ValueError(f"unsupported bpe tokenizer {kind!r}")
    return SentencePieceProcessor.load(cfg["sentencepiece_model"])


def apply_pre_tokenizer(cfg: Optional[Dict], text: str) -> str:
    """fairseq ``pre_tokenizer`` dict. Supported: none/space (whitespace
    collapse — the published recipes' setting)."""
    if not cfg:
        return text
    kind = cfg.get("tokenizer")
    if kind in (None, "", "none", "space"):
        return " ".join(text.split())
    raise ValueError(f"unsupported pre_tokenizer {kind!r}")
