"""Plain torch version of the segment sum."""
from __future__ import annotations

import torch


def segment_sum_ref(seg_ids: torch.Tensor, values: torch.Tensor,
                    n_groups: int) -> torch.Tensor:
    """seg_ids: [N] int (an id outside [0, n_groups) is padding); values:
    [N, C].  Returns ``[n_groups, C]`` float32 sums."""
    valid = (seg_ids >= 0) & (seg_ids < n_groups)
    safe = torch.where(valid, seg_ids, torch.zeros_like(seg_ids)).long()
    vals = torch.where(valid[:, None], values.to(torch.float32),
                       torch.zeros((), dtype=torch.float32,
                                   device=values.device))
    return torch.zeros((n_groups, values.shape[1]), dtype=torch.float32,
                       device=seg_ids.device).index_add_(0, safe, vals)
