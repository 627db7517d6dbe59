"""XML: tag-structured records.

Stands in for Silesia's xml.  Each record is one element with an id
attribute and child elements whose text comes from small Zipf-popular
sets (from the parameters' ``table_seed``, the same for every run), a number and a short phrase.
"""

from __future__ import annotations

import numpy as np

from ..gen_util import zipf_ranks


def generate(rng: np.random.Generator, nbytes: int, params: dict) -> bytes:
    table = np.random.default_rng(params["table_seed"])

    def words(count):
        return ["".join(chr(97 + c) for c in table.integers(0, 26, table.integers(3, 10)))
                for _ in range(count)]

    names = words(int(params["names"]))
    cities = words(int(params["cities"]))
    vocab = words(int(params["vocabulary"]))
    currencies = ("EUR", "USD", "PLN", "GBP")
    out, size, rid = [], 0, int(rng.integers(0, 10**6))
    while size < nbytes:
        n = 256
        nm = zipf_ranks(rng, len(names), 1.0, n)
        ct = zipf_ranks(rng, len(cities), 1.1, n)
        amt = rng.integers(0, 10**6, n)
        cur = rng.integers(0, 4, n)
        for i in range(n):
            note = " ".join(vocab[k] for k in zipf_ranks(rng, len(vocab), 1.0, int(rng.integers(2, 9))))
            rec = (f'<record id="{rid}"><name>{names[nm[i]]}</name>'
                   f"<city>{cities[ct[i]]}</city>"
                   f'<amount currency="{currencies[cur[i]]}">{amt[i] // 100}.{amt[i] % 100:02d}</amount>'
                   f"<note>{note}</note></record>\n")
            out.append(rec)
            size += len(rec)
            rid += 1
    return "".join(out).encode()[:nbytes]
