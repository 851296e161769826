"""The training documents and their packing, worked out independently of
the port: the yardstick for the rows the port's input pipeline hands to
the step.

A document window ``w`` of run seed ``s`` draws, from
``numpy.random.default_rng((s, w))``, in chunks of ``ceil(docs_per_window
/ num_splits)`` documents: each chunk's lengths (uniform over
``[2, max_doc_len]``), then a ``[chunk, max_doc_len]`` block of Zipf(1.3)
ranks, a token being ``rank % (vocab - 2) + 2``.  Documents shorter than
``min_doc_len`` are dropped; each kept document's first ``length`` tokens
and one ``eos_id`` join a stream, which is cut into rows of ``seq_len +
1`` tokens, the rest carried to the next window.  A global batch is the
next ``global_batch`` rows; the model reads a row's first ``seq_len``
tokens.

This mirrors the documented generator of ``data/pipeline.py`` so that the
packing, which the port runs on its ETL engine, is checked row for row.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _window_docs(tr: dict, vocab: int, seed: int, window: int):
    """The kept documents of one window, in order, as int32 arrays."""
    rng = np.random.default_rng((seed, window))
    total = tr["docs_per_window"]
    chunk = max(1, -(-total // tr["num_splits"]))
    mx = tr["max_doc_len"]
    docs = []
    left = total
    while left > 0:
        n = min(chunk, left)
        lengths = rng.integers(2, mx + 1, n).astype(np.int32)
        ranks = rng.zipf(1.3, size=(n, mx)).astype(np.int64)
        toks = (ranks % (vocab - 2) + 2).astype(np.int32)
        for i in range(n):
            if lengths[i] >= tr["min_doc_len"]:
                docs.append(toks[i, :lengths[i]])
        left -= n
    return docs


def global_batches(tr: dict, vocab: int, seed: int) -> Iterator[np.ndarray]:
    """Packed global batches [global_batch, seq_len + 1] (int32), in the
    order the step consumes them."""
    L = tr["seq_len"] + 1
    B = tr["global_batch"]
    eos = np.array([tr["eos_id"]], np.int32)
    carry = np.zeros(0, np.int32)
    pool = np.zeros((0, L), np.int32)
    window = 0
    while True:
        while len(pool) < B:
            parts = [carry]
            for d in _window_docs(tr, vocab, seed, window):
                parts += [d, eos]
            stream = np.concatenate(parts)
            n = len(stream) // L
            carry = stream[n * L:]
            pool = np.concatenate([pool, stream[:n * L].reshape(n, L)])
            window += 1
        yield pool[:B]
        pool = pool[B:]
