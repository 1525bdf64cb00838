"""Character-level tokenizer for the synthetic math RL task."""
from __future__ import annotations

from typing import List

_CHARS = "0123456789+-*=() "


class CharTokenizer:
    PAD = 0
    BOS = 1
    EOS = 2

    def __init__(self):
        self.itos = {self.PAD: "<pad>", self.BOS: "<bos>", self.EOS: "<eos>"}
        self.stoi = {}
        for i, ch in enumerate(_CHARS):
            tid = 3 + i
            self.itos[tid] = ch
            self.stoi[ch] = tid
        self.vocab_size = 3 + len(_CHARS)

    def encode(self, text: str, bos: bool = False) -> List[int]:
        ids = [self.stoi[c] for c in text]
        return ([self.BOS] if bos else []) + ids

    def decode(self, ids) -> str:
        return "".join(self.itos.get(int(i), "?") for i in ids
                       if int(i) not in (self.PAD, self.BOS, self.EOS))
