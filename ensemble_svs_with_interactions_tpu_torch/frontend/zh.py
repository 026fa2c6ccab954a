"""Chinese (Opencpop) phoneme inventory (a copy of the JAX package's
``frontend/zh.py``): NNSVS's inventory.  Opencpop uses SP for silence
and AP for breath; sil/pau/br are included for cross-database
consistency.
"""

from ensemble_svs_with_interactions_tpu_torch.frontend._inventory import make_vocab

phonemes = [
    "AP", "SP", "sil", "pau", "br",
    "a", "ai", "an", "ang", "ao", "b", "c", "ch", "d", "e", "ei", "en",
    "eng", "er", "f", "g", "h", "i", "ia", "ian", "iang", "iao", "ie",
    "in", "ing", "iong", "iu", "j", "k", "l", "m", "n", "o", "ong",
    "ou", "p", "q", "r", "s", "sh", "t", "u", "ua", "uai", "uan",
    "uang", "ui", "un", "uo", "v", "van", "ve", "vn", "w", "x", "y",
    "z", "zh",
]

symbols, num_vocab, text_to_sequence, sequence_to_text = make_vocab(phonemes)
