"""Offline tokenizer (R1): byte-level with optional trained BPE merges.

The paper tokenizes its entire binary-code corpus ahead of training and
stores only token ids + attention masks.  This tokenizer is byte-level
(natural for binary code) with a greedy BPE trained on a corpus sample so
the packed dataset achieves a real compression ratio.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Dict, Iterable, List, Tuple

PAD, CLS, SEP, MASK = 0, 1, 2, 3
N_SPECIAL = 4


class ByteBPETokenizer:
    """Byte alphabet (ids 4..259) + learned merges."""

    def __init__(self, merges: List[Tuple[int, int]] | None = None,
                 vocab_size: int = 32_768):
        self.vocab_size = vocab_size
        self.merges = merges or []
        self._ranks = {tuple(m): i for i, m in enumerate(self.merges)}

    # -- training -----------------------------------------------------------
    @classmethod
    def train(cls, samples: Iterable[bytes], vocab_size: int = 32_768,
              max_merges: int | None = None) -> "ByteBPETokenizer":
        max_merges = max_merges or (vocab_size - N_SPECIAL - 256)
        seqs = [[N_SPECIAL + b for b in s] for s in samples]
        merges: List[Tuple[int, int]] = []
        next_id = N_SPECIAL + 256
        for _ in range(max_merges):
            counts: collections.Counter = collections.Counter()
            for s in seqs:
                counts.update(zip(s, s[1:]))
            if not counts:
                break
            (a, b), n = counts.most_common(1)[0]
            if n < 2:
                break
            merges.append((a, b))
            seqs = [cls._merge_seq(s, a, b, next_id) for s in seqs]
            next_id += 1
            if next_id >= vocab_size:
                break
        return cls(merges, vocab_size)

    @staticmethod
    def _merge_seq(s: List[int], a: int, b: int, new_id: int) -> List[int]:
        out = []
        i = 0
        while i < len(s):
            if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                out.append(new_id)
                i += 2
            else:
                out.append(s[i])
                i += 1
        return out

    # -- encode / decode ------------------------------------------------------
    def encode(self, data: bytes) -> List[int]:
        s = [N_SPECIAL + b for b in data]
        for i, (a, b) in enumerate(self.merges):
            s = self._merge_seq(s, a, b, N_SPECIAL + 256 + i)
        return s

    def decode(self, ids: List[int]) -> bytes:
        # expand merges recursively
        table: Dict[int, Tuple[int, int]] = {
            N_SPECIAL + 256 + i: m for i, m in enumerate(self.merges)
        }

        def expand(i: int) -> List[int]:
            if i in table:
                a, b = table[i]
                return expand(a) + expand(b)
            return [i]

        out = []
        for i in ids:
            if i >= N_SPECIAL:
                out.extend(x - N_SPECIAL for x in expand(i))
        return bytes(out)

    # -- persistence -----------------------------------------------------------
    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"vocab_size": self.vocab_size,
                       "merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]], d["vocab_size"])
