"""Word error rate — jiwer-compatible, no external dependency.

A copy of ``mm_s2ut/eval/wer.py`` (the port imports nothing of the JAX
package). Equivalent of the reference WER module (SURVEY.md C17; reference
scripts/wer.py:85-95, which wraps HF-evaluate/jiwer): WER =
(S + D + I) / (S + D + C) computed over the *concatenated* corpus
(jiwer's default), plus per-utterance rates.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def edit_ops(ref: Sequence[str], hyp: Sequence[str]) -> Tuple[int, int, int, int]:
    """(substitutions, deletions, insertions, hits) via Levenshtein DP."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, S, D, I, H) — track op counts along an optimal path.
    INF = 10**9
    prev = [(j, 0, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0, 0)] + [None] * m
        for j in range(1, m + 1):
            sub_cost, s, d, ins, h = prev[j - 1]
            if ref[i - 1] == hyp[j - 1]:
                best = (sub_cost, s, d, ins, h + 1)
            else:
                best = (sub_cost + 1, s + 1, d, ins, h)
            del_c = prev[j]
            if del_c[0] + 1 < best[0]:
                best = (del_c[0] + 1, del_c[1], del_c[2] + 1, del_c[3], del_c[4])
            ins_c = cur[j - 1]
            if ins_c[0] + 1 < best[0]:
                best = (ins_c[0] + 1, ins_c[1], ins_c[2], ins_c[3] + 1, ins_c[4])
            cur[j] = best
        prev = cur
    _, s, d, ins, h = prev[m]
    return s, d, ins, h


def compute_wer(
    references: Sequence[str], predictions: Sequence[str]
) -> Dict[str, float]:
    """Corpus WER over whitespace tokens (jiwer semantics). Returns
    {"wer", "substitutions", "deletions", "insertions", "hits"}."""
    if len(references) != len(predictions):
        raise ValueError("references and predictions must align")
    S = D = I = H = 0
    for ref, hyp in zip(references, predictions):
        s, d, i, h = edit_ops(ref.split(), hyp.split())
        S, D, I, H = S + s, D + d, I + i, H + h
    denom = max(S + D + H, 1)
    return {
        "wer": (S + D + I) / denom,
        "substitutions": S,
        "deletions": D,
        "insertions": I,
        "hits": H,
    }


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Corpus WER (jiwer-compatible)")
    ap.add_argument("--references", required=True, help="text file, one ref per line")
    ap.add_argument("--predictions", required=True, help="text file, one hyp per line")
    args = ap.parse_args()
    refs = open(args.references).read().splitlines()
    hyps = open(args.predictions).read().splitlines()
    res = compute_wer(refs, hyps)
    print(f"WER: {res['wer'] * 100:.1f}%")
    print(
        f"S={res['substitutions']} D={res['deletions']} "
        f"I={res['insertions']} H={res['hits']}"
    )


if __name__ == "__main__":
    main()
