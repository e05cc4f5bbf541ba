"""N-gram language model: ARPA reader/writer, bigram trainer, dense table
(copy of ``ctc_pytorch_tpu/decode/ngram_lm.py``, host numpy).

Replaces both the IRSTLM training step (``timit/steps/train_lm.sh``: wrap
transcripts in <s>…</s>, train a bigram, emit text ARPA) and the reference's
ARPA consumer (``timit/utils/NgramLM.py``), whose semantics are preserved
exactly:

- ARPA stores log10 probabilities; scores are converted to natural log by
  multiplying with ln(10) (``NgramLM.py:22``);
- ``get_bi_prob(w1, w2)``: exact bigram if present, else backoff(w1) +
  unigram(w2); empty w1 -> <s>, empty w2 -> </s> (``NgramLM.py:65-78``);
- ``unigram['UNK']`` aliases <unk> when present.

For the batched on-device beam search the LM is exported as a dense
``(V+1, V+1)`` natural-log matrix over model-unit indices (+ sentinel row for
<s> context and column for </s>), so per-step LM lookup is one gather.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

LN10 = math.log(10)


class LanguageModel:
    def __init__(self, arpa_file: str | Path, n_gram: int = 2,
                 start: str = "<s>", end: str = "</s>", unk: str = "<unk>"):
        self.n_gram = n_gram
        self.start, self.end, self.unk = start, end, unk
        self.scale = LN10
        self.unigram: Dict[str, List[float]] = {}
        self.bigram: Dict[str, List[float]] = {}
        self._read_arpa(arpa_file)

    def _read_arpa(self, fn: str | Path) -> None:
        recording = 0
        for raw in Path(fn).read_text().splitlines():
            line = raw.strip("\n")
            if line == "\\1-grams:":
                recording = 1
                continue
            if line == "\\2-grams:":
                recording = 2
                continue
            if line.startswith("\\") or not line.strip():
                if line in ("\\end\\", "\\3-grams:"):
                    recording = 0
                continue
            parts = line.split("\t")
            if recording == 1 and len(parts) >= 2:
                prob = self.scale * float(parts[0])
                backoff = self.scale * float(parts[2]) if len(parts) == 3 else 0.0
                self.unigram[parts[1]] = [prob, backoff]
            elif recording == 2 and len(parts) >= 2:
                prob = self.scale * float(parts[0])
                backoff = self.scale * float(parts[2]) if len(parts) == 3 else 0.0
                self.bigram[parts[1]] = [prob, backoff]
        if self.unk in self.unigram:
            self.unigram["UNK"] = self.unigram[self.unk]

    # -- scoring (NgramLM.py:60-90 semantics) ----------------------------
    def get_uni_prob(self, word: str) -> float:
        return self.unigram[word][0]

    def get_bi_prob(self, w1: str, w2: str) -> float:
        if w1 == "":
            w1 = self.start
        if w2 == "":
            w2 = self.end
        key = w1 + " " + w2
        if key not in self.bigram:
            return self.unigram[w1][1] + self.unigram[w2][0]
        return self.bigram[key][0]

    def score_bg(self, sentence: str) -> float:
        words = sentence.strip().split()
        val = self.get_bi_prob(self.start, words[0])
        for a, b in zip(words, words[1:]):
            val += self.get_bi_prob(a, b)
        val += self.get_bi_prob(words[-1], self.end)
        return val

    # -- dense export for the batched beam kernel ------------------------
    def dense_table(self, int2char: Dict[int, str] | List[str],
                    num_class: int) -> np.ndarray:
        """(num_class+1, num_class+1) natural-log matrix.

        Row i (< num_class): context unit i; row num_class: <s> (empty
        history).  Column j (< num_class): next unit j; column num_class:
        </s>.  Units absent from the LM score like the reference would raise —
        we fall back to a large negative instead of crashing.
        """
        v = num_class
        table = np.full((v + 1, v + 1), -1e10, np.float32)
        def name(i):
            return int2char[i]
        for ci in range(v + 1):
            w1 = self.start if ci == v else name(ci)
            if w1 not in self.unigram:
                continue
            for cj in range(v + 1):
                w2 = self.end if cj == v else name(cj)
                if w2 not in self.unigram:
                    continue
                table[ci, cj] = self.get_bi_prob(w1, w2)
        return table


# ---------------------------------------------------------------------------
# Training (replaces IRSTLM build-lm.sh -n 2 / compile-lm)
# ---------------------------------------------------------------------------

def train_bigram_lm(
    sentences: Iterable[str],
    out_arpa: str | Path,
    start: str = "<s>",
    end: str = "</s>",
) -> None:
    """Train a Witten-Bell interpolated bigram LM and write text ARPA.

    Each input sentence is a whitespace-separated unit sequence; <s>/</s>
    wrapping mirrors ``train_lm.sh:18``.  Witten-Bell is IRSTLM's default
    smoothing for ``build-lm.sh``.
    """
    uni = Counter()
    bi = Counter()
    followers = defaultdict(set)
    n_sentences = 0
    for sent in sentences:
        toks = sent.strip().split()
        if not toks:
            continue
        n_sentences += 1
        seq = [start] + toks + [end]
        for w in seq:
            uni[w] += 1
        for a, b in zip(seq, seq[1:]):
            bi[(a, b)] += 1
            followers[a].add(b)

    # IRSTLM's build-lm.sh always emits an <unk> unigram (open vocabulary);
    # the reference's ARPA reader requires it (NgramLM.py:58 aliases
    # unigram['UNK'] to unigram['<unk>'] unconditionally)
    if "<unk>" not in uni:
        uni["<unk>"] = 0
    vocab = sorted(uni)
    total_tokens = sum(uni[w] for w in vocab if w != start)

    # unigram ML with Witten-Bell-style smoothing over the vocab
    v_types = len(vocab)
    uni_prob: Dict[str, float] = {}
    for w in vocab:
        count = uni[w] if w != start else 0  # <s> never predicted
        uni_prob[w] = (count + 1.0) / (total_tokens + v_types)

    # bigram: Witten-Bell interpolation
    # p(b|a) = c(ab)/(c(a)+T(a)) + T(a)/(c(a)+T(a)) * p(b)
    ctx_count = Counter()  # one pass: c(a) = sum_b c(ab)
    for (a, _), c in bi.items():
        ctx_count[a] += c
    bi_prob: Dict[Tuple[str, str], float] = {}
    backoff: Dict[str, float] = {}
    for a in vocab:
        if a == end:
            continue
        ca = ctx_count[a]
        ta = len(followers[a])
        if ca == 0:
            backoff[a] = 1.0
            continue
        lam = ta / (ca + ta)  # mass reserved for unseen followers
        # cab > 0 exactly for b in followers[a]; <s> is never a follower
        for b in sorted(followers[a]):
            bi_prob[(a, b)] = bi[(a, b)] / (ca + ta) + lam * uni_prob[b]
        # backoff weight: remaining mass / remaining unigram mass
        seen_mass = sum(bi_prob[(a, b)] for b in followers[a] if (a, b) in bi_prob)
        unseen_uni = sum(
            uni_prob[b] for b in vocab if b != start and (a, b) not in bi_prob
        )
        backoff[a] = max((1.0 - seen_mass), 1e-10) / max(unseen_uni, 1e-10)

    _write_arpa(out_arpa, vocab, uni_prob, backoff, bi_prob, start)


def _write_arpa(path, vocab, uni_prob, backoff, bi_prob, start) -> None:
    def lg(x):
        return math.log10(max(x, 1e-99))

    lines = ["", "\\data\\",
             f"ngram 1={len(vocab)}", f"ngram 2={len(bi_prob)}", "",
             "\\1-grams:"]
    for w in sorted(vocab):
        p = uni_prob[w] if w != start else 1e-99  # ARPA convention: p(<s>)≈0
        bo = backoff.get(w, 1.0)
        lines.append(f"{lg(p):.6f}\t{w}\t{lg(bo):.6f}")
    lines.append("")
    lines.append("\\2-grams:")
    for (a, b), p in sorted(bi_prob.items()):
        lines.append(f"{lg(p):.6f}\t{a} {b}")
    lines.append("")
    lines.append("\\end\\")
    Path(path).write_text("\n".join(lines) + "\n")
