"""Catalog-chunking policy and local-column scatter masks; the port of
`sagnn_tpu/ops/chunking.py`.
"""

from __future__ import annotations

import torch

# One policy for "when to stream a catalog, and how wide": dense scoring
# up to DENSE_MAX_ROWS rows, streamed in AUTO_CHUNK_ROWS chunks past it
# (the same thresholds as the JAX package, so both pick the same path).
DENSE_MAX_ROWS = 131_072
AUTO_CHUNK_ROWS = 65_536


def auto_chunk_rows(n_rows: int) -> int:
    """Resolve the auto (0) chunk setting: -1 = score densely,
    >0 = stream in chunks of this many rows."""
    return AUTO_CHUNK_ROWS if n_rows > DENSE_MAX_ROWS else -1


def scatter_local_mask(ids: torch.Tensor, base: int, width: int,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """[B, width] bool: True at local column (ids - base) for every id that
    lands inside [base, base + width), optionally gated by `valid` > 0.

    Ids outside the window give negative or too-large offsets; torch
    indexing would wrap a negative one, so the range is masked explicitly
    and the offsets clipped before the scatter. Duplicate columns combine
    by OR (an int32 count, then > 0), so the result is deterministic.
    """
    B, K = ids.shape
    loc = ids.long() - base
    ok = (loc >= 0) & (loc < width)
    if valid is not None:
        ok = ok & (valid > 0)
    rows = torch.arange(B, device=ids.device).repeat_interleave(K)
    cols = loc.clamp(0, width - 1).reshape(-1)
    hits = torch.zeros((B, width), dtype=torch.int32, device=ids.device)
    hits.index_put_((rows, cols), ok.reshape(-1).to(torch.int32),
                    accumulate=True)
    return hits > 0
