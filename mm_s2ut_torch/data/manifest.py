"""TSV manifest reader (stdlib only).

A copy of the reader and writer in ``mm_s2ut/data/manifest.py``. Mandatory columns:
``id, src_audio, src_n_frames, tgt_text, tgt_n_frames``; optional
``src_lang, tgt_lang``.
"""
from __future__ import annotations

import csv
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

MANDATORY = ("id", "src_audio", "src_n_frames", "tgt_text", "tgt_n_frames")


@dataclass
class ManifestRow:
    id: str
    src_audio: str
    src_n_frames: int
    tgt_text: str
    tgt_n_frames: int
    src_lang: str = ""
    tgt_lang: str = ""
    extra: Dict[str, str] = field(default_factory=dict)


def read_manifest(path: str | Path) -> List[ManifestRow]:
    rows: List[ManifestRow] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(
            f, delimiter="\t", quotechar=None, quoting=csv.QUOTE_NONE,
            doublequote=False, lineterminator="\n", escapechar="\\",
        )
        if reader.fieldnames is None:
            return rows
        missing = [k for k in MANDATORY if k not in reader.fieldnames]
        if missing:
            raise ValueError(f"manifest {path} missing columns {missing}")
        for rec in reader:
            rows.append(ManifestRow(
                id=rec["id"],
                src_audio=rec["src_audio"],
                src_n_frames=int(rec["src_n_frames"]),
                tgt_text=rec["tgt_text"],
                tgt_n_frames=int(rec["tgt_n_frames"]),
                src_lang=rec.get("src_lang") or "",
                tgt_lang=rec.get("tgt_lang") or "",
                extra={
                    k: v for k, v in rec.items()
                    if k not in (*MANDATORY, "src_lang", "tgt_lang")
                },
            ))
    return rows


def write_manifest(path: str | Path, rows: List[ManifestRow]) -> None:
    has_lang = any(r.src_lang or r.tgt_lang for r in rows)
    fields = list(MANDATORY) + (["src_lang", "tgt_lang"] if has_lang else [])
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(fields)
        for r in rows:
            rec = [r.id, r.src_audio, r.src_n_frames, r.tgt_text, r.tgt_n_frames]
            if has_lang:
                rec += [r.src_lang, r.tgt_lang]
            w.writerow(rec)
