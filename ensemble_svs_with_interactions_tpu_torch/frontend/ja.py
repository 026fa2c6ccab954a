"""Japanese (Sinsy-style) phoneme inventory (a copy of the JAX package's
``frontend/ja.py``): NNSVS's inventory, so that packed models and
phoneme-embedding tables are interchangeable.
"""

from ensemble_svs_with_interactions_tpu_torch.frontend._inventory import make_vocab

phonemes = [
    "A", "E", "I", "N", "O", "U",
    "a", "b", "br", "by", "ch", "cl", "d", "dy", "e", "f", "g", "gy",
    "h", "hy", "i", "j", "k", "ky", "m", "my", "n", "ny", "o", "p",
    "py", "r", "ry", "s", "sh", "t", "ts", "ty", "u", "v", "w", "y",
    "z", "pau", "sil", "fy", "vy", "GlottalStop", "Edge",
]

symbols, num_vocab, text_to_sequence, sequence_to_text = make_vocab(phonemes)
