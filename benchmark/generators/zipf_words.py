"""Prose: words of a vocabulary drawn by Zipf popularity.

Stands in for Silesia's dickens, reymont and webster.  The vocabulary
(from the parameters' ``table_seed``, the same for every run) has words
with lengths and letters in English proportions; sentence and clause
marks and line breaks are tokens of their own among the words.
"""

from __future__ import annotations

import numpy as np

from ..gen_util import emit

# English letter frequencies, a-z (percent).
LETTERS = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15,
                    0.77, 4.0, 2.4, 6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1,
                    2.8, 0.98, 2.4, 0.15, 2.0, 0.074])


def generate(rng: np.random.Generator, nbytes: int, params: dict) -> bytes:
    vocab = int(params["vocabulary"])
    table = np.random.default_rng(params["table_seed"])
    lens = np.clip(table.poisson(params["mean_word_length"] - 1, vocab) + 1, 1, 16)
    letters = table.choice(26, size=int(lens.sum()), p=LETTERS / LETTERS.sum())
    letters = (letters + ord("a")).astype(np.uint8).tobytes()
    words, at = [], 0
    for n in lens:
        words.append(letters[at : at + n] + b" ")
        at += n
    # Marks among the most frequent tokens, as in running text.
    for rank, mark in enumerate(params["marks"]):
        words.insert(int(params["mark_ranks"][rank]), mark.encode())
    return emit(rng, words, float(params["zipf_s"]), nbytes)
