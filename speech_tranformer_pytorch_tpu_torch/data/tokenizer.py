"""Tokenizers (counterpart of the JAX package's ``data/tokenizer.py``).

``CharTokenizer``: one character a token after whitespace removal (the
AISHELL recipe). ``BpeTokenizer``: greedy-merge BPE over whitespace-split
words with an end-of-word marker (the LibriSpeech preset). Both keep the
four specials first; ``PAD``, ``SOS``, ``EOS`` and ``UNK`` are defined here
once for the whole port. ``save`` writes the same JSON bytes as the JAX
package, so either package loads the other's vocabulary.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, List, Sequence, Tuple

PAD, SOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = ["<pad>", "<sos>", "<eos>", "<unk>"]


def normalize_text(text: str) -> str:
    """Strip whitespace entirely (characters as tokens) and upper-case Latin."""
    return "".join(text.upper().split())


class CharTokenizer:
    def __init__(self, vocab: Dict[str, int]):
        self.vocab = dict(vocab)
        self.inv = {i: c for c, i in self.vocab.items()}

    @classmethod
    def train(cls, texts: Iterable[str], *, min_count: int = 1) -> "CharTokenizer":
        counts = collections.Counter()
        for t in texts:
            counts.update(normalize_text(t))
        vocab = {s: i for i, s in enumerate(SPECIALS)}
        for ch, n in sorted(counts.items()):
            if n >= min_count:
                vocab[ch] = len(vocab)
        return cls(vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(ch, UNK) for ch in normalize_text(text)]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.inv.get(int(i), "<unk>") for i in ids
                       if int(i) not in (PAD, SOS, EOS))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"type": "char", "vocab": self.vocab}, f,
                      ensure_ascii=False, indent=0)

    @classmethod
    def load(cls, path: str) -> "CharTokenizer":
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        if d["type"] != "char":
            raise ValueError(f"{path}: tokenizer type {d['type']!r}, not 'char'")
        return cls(d["vocab"])


_EOW = "</w>"


class BpeTokenizer:
    """``merges``: ordered (a, b) pairs; ``vocab``: token string -> id."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.inv = {i: t for t, i in self.vocab.items()}
        self.merges = list(merges)
        self.merge_rank = {tuple(m): r for r, m in enumerate(merges)}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int,
              *, min_pair_count: int = 2) -> "BpeTokenizer":
        word_counts = collections.Counter()
        for t in texts:
            for w in t.upper().split():
                word_counts[w] += 1
        words = {w: list(w) + [_EOW] for w in word_counts}
        vocab = {s: i for i, s in enumerate(SPECIALS)}
        for sym in sorted({s for syms in words.values() for s in syms}):
            vocab.setdefault(sym, len(vocab))

        merges: List[Tuple[str, str]] = []
        while len(vocab) < vocab_size:
            pair_counts = collections.Counter()
            for w, syms in words.items():
                n = word_counts[w]
                for a, b in zip(syms, syms[1:]):
                    pair_counts[(a, b)] += n
            if not pair_counts:
                break
            (a, b), cnt = pair_counts.most_common(1)[0]
            if cnt < min_pair_count:
                break
            merges.append((a, b))
            new_sym = a + b
            vocab.setdefault(new_sym, len(vocab))
            for w, syms in words.items():
                out, i = [], 0
                while i < len(syms):
                    if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                        out.append(new_sym)
                        i += 2
                    else:
                        out.append(syms[i])
                        i += 1
                words[w] = out
        return cls(vocab, merges)

    def _encode_word(self, word: str) -> List[str]:
        syms = list(word) + [_EOW]
        while len(syms) > 1:
            best, best_rank = None, None
            for i, (a, b) in enumerate(zip(syms, syms[1:])):
                r = self.merge_rank.get((a, b))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            syms[best:best + 2] = [syms[best] + syms[best + 1]]
        return syms

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(s, UNK) for w in text.upper().split()
                for s in self._encode_word(w)]

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv.get(int(i), "<unk>") for i in ids
                if int(i) not in (PAD, SOS, EOS)]
        return "".join(toks).replace(_EOW, " ").strip()

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"type": "bpe", "vocab": self.vocab,
                       "merges": self.merges}, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        if d["type"] != "bpe":
            raise ValueError(f"{path}: tokenizer type {d['type']!r}, not 'bpe'")
        return cls(d["vocab"], [tuple(m) for m in d["merges"]])


def load_tokenizer(path: str):
    """The char or BPE tokenizer saved at ``path``, by its ``type``."""
    with open(path, encoding="utf-8") as f:
        d = json.load(f)
    if d["type"] == "char":
        return CharTokenizer(d["vocab"])
    if d["type"] == "bpe":
        return BpeTokenizer(d["vocab"], [tuple(m) for m in d["merges"]])
    raise ValueError(f"unknown tokenizer type {d['type']!r}")
