"""R1: tokenize + pack the corpus offline, storing ONLY what training needs
(uint16 token ids + attention masks) in fixed-length examples.

Packed shard format: ``<name>.tokens.npy`` (uint16, [n_examples, seq_len])
and ``<name>.mask.npy`` (uint8).  Examples are [CLS] fn [SEP] fn ... packed
to seq_len, the paper's MLM input shape.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Tuple

import numpy as np

from repro_torch.data.tokenizer import CLS, PAD, SEP, ByteBPETokenizer


@dataclass(frozen=True)
class PackedShard:
    tokens_path: str
    mask_path: str

    def load(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.load(self.tokens_path, mmap_mode="r"),
                np.load(self.mask_path, mmap_mode="r"))

    @property
    def nbytes(self) -> int:
        return (os.path.getsize(self.tokens_path)
                + os.path.getsize(self.mask_path))


def pack_corpus(functions: Iterable[bytes], tok: ByteBPETokenizer,
                out_prefix: str, seq_len: int = 512,
                shard_examples: int = 4096) -> List[PackedShard]:
    """Tokenizes, packs into fixed-length rows, writes shards; returns them."""
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    shards: List[PackedShard] = []
    rows_tok: List[np.ndarray] = []
    rows_mask: List[np.ndarray] = []
    cur: List[int] = [CLS]

    def flush_row():
        nonlocal cur
        n = len(cur)
        row = np.full((seq_len,), PAD, np.uint16)
        row[:n] = np.asarray(cur[:seq_len], np.uint16)
        mask = np.zeros((seq_len,), np.uint8)
        mask[:min(n, seq_len)] = 1
        rows_tok.append(row)
        rows_mask.append(mask)
        cur = [CLS]

    def flush_shard():
        idx = len(shards)
        tp = f"{out_prefix}.{idx:05d}.tokens.npy"
        mp = f"{out_prefix}.{idx:05d}.mask.npy"
        np.save(tp, np.stack(rows_tok))
        np.save(mp, np.stack(rows_mask))
        shards.append(PackedShard(tp, mp))
        rows_tok.clear()
        rows_mask.clear()

    for fn in functions:
        ids = tok.encode(fn) + [SEP]
        while ids:
            space = seq_len - len(cur)
            take, ids = ids[:space], ids[space:]
            cur.extend(take)
            if len(cur) >= seq_len:
                flush_row()
        if len(cur) > 1 and len(cur) >= seq_len:
            flush_row()
        if len(rows_tok) >= shard_examples:
            flush_shard()
    if len(cur) > 1:
        flush_row()
    if rows_tok:
        flush_shard()
    return shards


def size_reduction(raw_bytes: int, shards: List[PackedShard]) -> float:
    packed = sum(s.nbytes for s in shards)
    return 1.0 - packed / raw_bytes
