"""Plain torch version of the selective scan: a loop over time steps."""
from __future__ import annotations

from typing import Tuple

import torch


def mamba_scan_ref(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta, x: [Bt, T, d]; B, C: [Bt, T, N]; A: [d, N]; h0: [Bt, d, N].
    Returns (y [Bt, T, d], hT [Bt, d, N]), all fp32."""
    delta, x, B, C, A, h = (t.float() for t in (delta, x, B, C, A, h0))
    ys = []
    for t in range(delta.shape[1]):
        d_t = delta[:, t, :, None]                       # [Bt, d, 1]
        dA = torch.exp(d_t * A)                          # [Bt, d, N]
        dBx = d_t * B[:, t, None, :] * x[:, t, :, None]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else delta.new_zeros(delta.shape))
    return y, h
