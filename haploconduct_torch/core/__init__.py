"""Core in-memory data model: reads, packed device batches, edges."""

from .reads import (
    A, C, G, T, N_CODE, PAD_CODE,
    ReadStore,
    encode_seq,
    decode_seq,
    revcomp_codes,
    revcomp_str,
)
