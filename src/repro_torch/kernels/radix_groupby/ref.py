"""Plain torch version of the radix-partitioned groupby: grouped float32
sums and occupancy counts over dense group ids."""
from __future__ import annotations

from typing import Tuple

import torch


def radix_groupby_ref(ids: torch.Tensor, values: torch.Tensor, n_groups: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids: [N] int (a row with an id outside [0, n_groups) is padding);
    values: [N, C] (C may be 0).  Returns ``(sums [n_groups, C] float32,
    counts [n_groups] float32)`` — counts are float32 row tallies (exact
    below 2^24 rows per group), as the kernel accumulates them."""
    valid = (ids >= 0) & (ids < n_groups)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    vals = torch.where(valid[:, None], values.to(torch.float32),
                       torch.zeros((), dtype=torch.float32,
                                   device=values.device))
    ext = torch.cat([vals, valid.to(torch.float32)[:, None]], dim=1)
    out = torch.zeros((n_groups, ext.shape[1]), dtype=torch.float32,
                      device=ids.device).index_add_(0, safe, ext)
    return out[:, :-1], out[:, -1]
