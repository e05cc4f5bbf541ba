"""Unit (phone/character/syllable) vocabulary.

Reproduces the index contract of ``timit/utils/data_loader.py:13-47``:
``blank`` is index 0, ``UNK`` is index 1, and units are numbered in file
order after that.  ``n_words`` is the model's output class count.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List

BLANK = "blank"
UNK = "UNK"
BLANK_ID = 0
UNK_ID = 1


class Vocab:
    def __init__(self, vocab_file: str | Path | None = None):
        self.word2index: Dict[str, int] = {BLANK: BLANK_ID, UNK: UNK_ID}
        self.index2word: Dict[int, str] = {BLANK_ID: BLANK, UNK_ID: UNK}
        self.word2count: Dict[str, int] = {}
        self.n_words = 2
        self.vocab_file = str(vocab_file) if vocab_file is not None else None
        if vocab_file is not None:
            self.read_lang(vocab_file)

    # -- construction ---------------------------------------------------
    def add_word(self, word: str) -> int:
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.index2word[self.n_words] = word
            self.word2count[word] = 0
            self.n_words += 1
        self.word2count[word] = self.word2count.get(word, 0) + 1
        return self.word2index[word]

    def add_sentence(self, sentence: str) -> None:
        for word in sentence.strip().split(" "):
            if word:
                self.add_word(word)

    def read_lang(self, vocab_file: str | Path) -> None:
        """Units file in file order (``read_lang``, ``data_loader.py:36-47``):
        single-column lines add the unit; multi-column lines (e.g. a lexicon
        ``word p1 p2``) add every field after the first, like the reference."""
        for line in Path(vocab_file).read_text().splitlines():
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) > 1:
                for word in parts[1:]:
                    self.add_word(word)
            else:
                self.add_word(parts[0])

    @classmethod
    def from_units(cls, units: Iterable[str]) -> "Vocab":
        v = cls()
        for u in units:
            v.add_word(u)
        return v

    # -- mapping ---------------------------------------------------------
    def encode(self, sentence: str) -> List[int]:
        """Tokenise a transcript line; OOV units map to UNK (id 1)."""
        return [
            self.word2index.get(w, UNK_ID)
            for w in sentence.strip().split(" ")
            if w
        ]

    def decode(self, ids: Iterable[int]) -> List[str]:
        return [self.index2word.get(int(i), UNK) for i in ids]

    def units(self) -> List[str]:
        """All non-special units in index order."""
        return [self.index2word[i] for i in range(2, self.n_words)]

    def save(self, path: str | Path) -> None:
        Path(path).write_text("\n".join(self.units()) + "\n")

    def __len__(self) -> int:
        return self.n_words

    def __contains__(self, word: str) -> bool:
        return word in self.word2index


def build_units(label_files: Iterable[str | Path], out_path: str | Path) -> Vocab:
    """Scan transcript files and emit a sorted-unique units file.

    Mirrors ``timit/steps/get_model_units.py:1-27`` (which sorts units).
    Label line format: ``<utt-id> <unit> <unit> ...``.
    """
    units = set()
    for lf in label_files:
        for line in Path(lf).read_text().splitlines():
            parts = line.strip().split()
            units.update(parts[1:])
    ordered = sorted(units)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text("\n".join(ordered) + "\n")
    return Vocab.from_units(ordered)
