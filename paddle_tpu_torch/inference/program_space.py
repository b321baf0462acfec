"""Chunk-width arithmetic of the paged engine's chunked prefill.

Port of ``MAX_PREFILL_CHUNKS`` and ``chunk_for`` from
``paddle_tpu/inference/program_space.py``: the engine's
``_prefill_chunk_for`` calls ``chunk_for``. The rest of that module (the
program space, workload envelopes and their enumeration) is not ported
yet.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["MAX_PREFILL_CHUNKS", "chunk_for"]

# how many chunk steps a full-width prefill may take: a prefill starts only
# while 2 x its chunks fit the segment's step budget, so a finer chunk
# narrows the window in which long prompts can start
MAX_PREFILL_CHUNKS = 4


def chunk_for(prefill_chunks: Sequence[int], s_max: int) -> int:
    """Chunk width for an ``s_max``-wide admit window: the smallest entry
    of the ascending ladder ``prefill_chunks`` that prefills the whole
    window in at most ``MAX_PREFILL_CHUNKS`` chunks, else the largest
    entry."""
    for c in prefill_chunks:
        if c * MAX_PREFILL_CHUNKS >= s_max:
            return int(c)
    return int(prefill_chunks[-1])
