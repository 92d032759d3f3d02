"""ASR-BLEU scoring — the reference's end metric, without sacrebleu.

Port of ``mm_s2ut/eval/bleu.py``: hypotheses (ASR transcripts of
generated speech, ordered by wav index) are aligned to references through
the TSV ``id`` column (``ref_list[ref_id_list[i] - 1]``), both sides
cleaned (english_cleaners), trailing periods stripped, then corpus BLEU.
The JAX package calls ``sacrebleu.corpus_bleu``; the port computes the
same score itself with sacrebleu's defaults, so it needs no package the
card's machine lacks: the ``13a`` tokenizer (mteval-v13a), n-grams up to
4 against one reference per line, clipped counts summed over the corpus,
the brevity penalty exp(1 − ref_len / hyp_len) when the hypotheses are
shorter, and ``exp`` smoothing (an order with no match counts
100 / (2^k · total), the k-th such order).
"""
from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

from mm_s2ut_torch.eval.text_cleaner import english_cleaners

MAX_ORDER = 4

# mteval-v13a's language-independent regexes, in order (sacrebleu's
# TokenizerRegexp): symbols split off, then periods and commas unless
# next to a digit, then a dash after a digit.
_13A = [
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def tokenize_13a(line: str) -> str:
    """mteval-v13a tokenization, as sacrebleu's ``13a`` tokenizer."""
    line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
    if "&" in line:
        line = (line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<")
                .replace("&gt;", ">"))
    line = f" {line} "
    for pattern, repl in _13A:
        line = pattern.sub(repl, line)
    return " ".join(line.split())


def _ngrams(tokens: List[str]) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for n in range(1, MAX_ORDER + 1)
                   for i in range(len(tokens) - n + 1))


@dataclass
class BLEUScore:
    """Corpus BLEU (``score``, 0-100) and its statistics, printed as
    sacrebleu prints its score."""

    score: float
    counts: List[int]
    totals: List[int]
    precisions: List[float]
    bp: float
    sys_len: int
    ref_len: int

    def __str__(self) -> str:
        ratio = self.sys_len / self.ref_len if self.ref_len else 0
        prec = "/".join(f"{p:.1f}" for p in self.precisions)
        return (f"BLEU = {self.score:.2f} {prec} (BP = {self.bp:.3f} ratio = {ratio:.3f} "
                f"hyp_len = {self.sys_len:d} ref_len = {self.ref_len:d})")


def corpus_bleu(hypotheses: Sequence[str], references: Sequence[str]) -> BLEUScore:
    """sacrebleu's ``corpus_bleu(hypotheses, [references])`` with its
    defaults (13a, exp smoothing, case kept)."""
    if len(hypotheses) != len(references):
        raise ValueError(f"{len(hypotheses)} hypotheses vs {len(references)} references")
    counts, totals = [0] * MAX_ORDER, [0] * MAX_ORDER
    sys_len = ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        h = tokenize_13a(hyp.rstrip()).split()
        r = tokenize_13a(ref.rstrip()).split()
        sys_len, ref_len = sys_len + len(h), ref_len + len(r)
        ref_grams = _ngrams(r)
        for gram, c in _ngrams(h).items():
            totals[len(gram) - 1] += c
            counts[len(gram) - 1] += min(c, ref_grams.get(gram, 0))
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * MAX_ORDER
    if not any(counts):
        return BLEUScore(0.0, counts, totals, precisions, bp, sys_len, ref_len)
    smooth = 1.0
    for n in range(MAX_ORDER):
        if totals[n] == 0:
            break
        if counts[n] == 0:
            smooth *= 2
            precisions[n] = 100.0 / (smooth * totals[n])
        else:
            precisions[n] = 100.0 * counts[n] / totals[n]
    log_sum = sum(-9999999999 if p == 0.0 else math.log(p) for p in precisions)
    return BLEUScore(bp * math.exp(log_sum / MAX_ORDER), counts, totals, precisions, bp,
                     sys_len, ref_len)


def clean_line(text: str) -> str:
    text = english_cleaners(text.strip())
    if text.endswith("."):
        text = text[:-1].strip()
    return text


def align_refs_by_id(refs: Sequence[str], ref_ids: Sequence[int]) -> List[str]:
    """hyp i corresponds to refs[ref_ids[i] - 1] (1-based wav naming —
    the reference's filename-stem convention)."""
    return [refs[i - 1] for i in ref_ids]


def corpus_asr_bleu(hypotheses: Sequence[str], references: Sequence[str],
                    clean: bool = True) -> BLEUScore:
    """Corpus BLEU of the transcripts, both sides cleaned by default."""
    if clean:
        hypotheses = [clean_line(h) for h in hypotheses]
        references = [clean_line(r) for r in references]
    return corpus_bleu(list(hypotheses), list(references))


def score_from_files(transcript_file: str | Path, reference_file: str | Path,
                     manifest_file: Optional[str | Path] = None) -> BLEUScore:
    """Transcripts (one per wav, index order), references (one per line),
    and an optional TSV manifest whose ``id`` column re-aligns the
    references to the transcripts' order."""
    hyps = Path(transcript_file).read_text().splitlines()
    refs = Path(reference_file).read_text().splitlines()
    if manifest_file is not None:
        from mm_s2ut_torch.data.manifest import read_manifest

        rows = read_manifest(manifest_file)
        # Audio stems are 1-based line numbers into the reference file.
        refs = align_refs_by_id(refs, [int(Path(r.src_audio).stem) for r in rows])
    if len(hyps) != len(refs):
        raise ValueError(f"{len(hyps)} hyps vs {len(refs)} refs")
    return corpus_asr_bleu(hyps, refs)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.eval.bleu",
                                 description="ASR-BLEU (corpus BLEU, sacrebleu's defaults)")
    ap.add_argument("--transcripts", required=True)
    ap.add_argument("--references", required=True)
    ap.add_argument("--manifest", default=None, help="TSV for id-based ref alignment")
    args = ap.parse_args(argv)
    bleu = score_from_files(args.transcripts, args.references, args.manifest)
    print(f"BLEU Score: {bleu.score:.1f}")
    print(bleu)


if __name__ == "__main__":
    main()
