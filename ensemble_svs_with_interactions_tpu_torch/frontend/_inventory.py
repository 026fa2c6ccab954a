"""Shared helpers for language phoneme inventories (a copy of the JAX
package's ``frontend/_inventory.py``).

Each language module exposes ``phonemes``, ``symbols`` (with a leading pad
token), ``num_vocab``, ``text_to_sequence`` and ``sequence_to_text`` —
the same surface as the reference's nnsvs/frontend/{ja,zh}.py.
"""

from __future__ import annotations

from typing import List

PAD = "~"


def make_vocab(phonemes: List[str]):
    symbols = [PAD] + list(phonemes)
    to_id = {s: i for i, s in enumerate(symbols)}
    to_symbol = {i: s for i, s in enumerate(symbols)}

    def num_vocab() -> int:
        return len(symbols)

    def text_to_sequence(text):
        return [to_id[s] for s in text]

    def sequence_to_text(seq):
        return [to_symbol[int(s)] for s in seq]

    return symbols, num_vocab, text_to_sequence, sequence_to_text
