"""The port's LM kernel packages (``repro_torch.kernels.flash_attention``,
``.mamba_scan``) against the JAX reference on the same numpy inputs.

On the CPU each wrapper runs its plain torch version.  The reference's
flash attention runs its Pallas body in interpret mode; its mamba scan is
held through ``mamba_scan_ref`` only, because the reference's interpret
route for that kernel does not run on this jax.  Tolerances: fp32 flash
attention within rtol 2e-4 / atol 2e-5, bf16 within 2e-2 (the outputs are
rounded to bf16); the fp32 scan within rtol 1e-4 / atol 1e-4 (fp32 sums in
other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.mamba_scan import mamba_scan_ref as ref_scan
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref

RNG = np.random.default_rng(17)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ---------------------------------------------------------- flash attention
@pytest.mark.parametrize("B,Sq,Skv,Kh,G,hd,causal,window,softcap,bq,bk", [
    (1, 64, 64, 1, 1, 32, True, 0, 0.0, 32, 32),
    (2, 128, 128, 2, 2, 64, True, 0, 0.0, 32, 64),
    (2, 128, 128, 2, 2, 64, False, 0, 0.0, 64, 32),
    (1, 96, 96, 2, 4, 32, True, 24, 0.0, 32, 32),     # sliding window
    (1, 64, 64, 4, 1, 64, True, 0, 30.0, 32, 32),     # grok softcap
    (2, 80, 80, 1, 8, 16, True, 0, 0.0, 32, 32),      # ragged blocks
    (1, 33, 57, 1, 2, 8, False, 0, 0.0, 16, 16),      # cross-attn shapes
])
def test_flash_plain_matches_reference_interpret(B, Sq, Skv, Kh, G, hd,
                                                 causal, window, softcap,
                                                 bq, bk):
    q = RNG.normal(size=(B, Sq, Kh, G, hd)).astype(np.float32)
    k = RNG.normal(size=(B, Skv, Kh, hd)).astype(np.float32)
    v = RNG.normal(size=(B, Skv, Kh, hd)).astype(np.float32)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, softcap=softcap,
                     impl="interpret", block_q=bq, block_k=bk)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_flash_plain_bf16_matches_reference_interpret():
    B, S, Kh, G, hd = 1, 64, 2, 2, 32
    q, k, v = (RNG.normal(size=s).astype(np.float32)
               for s in ((B, S, Kh, G, hd), (B, S, Kh, hd), (B, S, Kh, hd)))
    want = ref_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     causal=True, impl="interpret", block_q=32, block_k=32)
    got = flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                          causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_flash_plain_fully_masked_rows_are_zero():
    """Rows with no allowed key give 0, as the TPU kernel's l == 0 flush."""
    q = _t(RNG.normal(size=(1, 40, 1, 1, 16)))
    k = _t(RNG.normal(size=(1, 8, 1, 16)))
    out = flash_attention(q, k, k.clone(), causal=False, window=4)
    want = ref_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                     jnp.asarray(k.numpy()), causal=False, window=4,
                     impl="interpret", block_q=16, block_k=8)
    assert torch.count_nonzero(out[:, 11:]) == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


# ---------------------------------------------------------------- mamba scan
def _scan_inputs(Bt, T, d, N, h0_zero=False):
    delta = np.abs(RNG.normal(size=(Bt, T, d))).clip(0.01, 1.0)
    x = RNG.normal(size=(Bt, T, d))
    B = RNG.normal(size=(Bt, T, N))
    C = RNG.normal(size=(Bt, T, N))
    A = -np.abs(RNG.normal(size=(d, N))) - 0.05
    h0 = np.zeros((Bt, d, N)) if h0_zero else RNG.normal(size=(Bt, d, N))
    return [a.astype(np.float32) for a in (delta, x, B, C, A, h0)]


@pytest.mark.parametrize("Bt,T,d,N", [(1, 16, 8, 4), (2, 48, 24, 8),
                                      (2, 100, 32, 16), (1, 64, 48, 16)])
def test_mamba_plain_matches_reference(Bt, T, d, N):
    arrs = _scan_inputs(Bt, T, d, N)
    y_ref, hT_ref = ref_scan(*(jnp.asarray(a) for a in arrs))
    y, hT = mamba_scan(*(_t(a) for a in arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hT_ref), rtol=1e-4,
                               atol=1e-4)


def test_mamba_plain_continuation():
    """Scanning [0:T1) then [T1:T) from hT equals scanning [0:T)."""
    delta, x, B, C, A, h0 = (_t(a) for a in _scan_inputs(1, 32, 8, 4,
                                                          h0_zero=True))
    y_full, hT_full = mamba_scan(delta, x, B, C, A, h0)
    y1, h1 = mamba_scan(delta[:, :16], x[:, :16], B[:, :16], C[:, :16], A,
                        h0)
    y2, h2 = mamba_scan(delta[:, 16:], x[:, 16:], B[:, 16:], C[:, 16:], A,
                        h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(h2, hT_full, rtol=1e-4, atol=1e-4)
    y_ref, hT_ref = ref_scan(*(jnp.asarray(t.numpy())
                               for t in (delta, x, B, C, A, h0)))
    np.testing.assert_allclose(h2.numpy(), np.asarray(hT_ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("Bt,T,d,N", [(1, 16, 8, 4), (2, 40, 24, 5)])
def test_mamba_plain_bf16_inputs_equal_widened(Bt, T, d, N):
    """bf16 delta and x give the widened call's result bit for bit (the
    widening is exact), and stand against the reference on the widened
    inputs within the fp32 tolerance."""
    arrs = [_t(a) for a in _scan_inputs(Bt, T, d, N)]
    delta, x = (a.to(torch.bfloat16) for a in arrs[:2])
    y, hT = mamba_scan(delta, x, *arrs[2:])
    y_w, hT_w = mamba_scan(delta.float(), x.float(), *arrs[2:])
    assert y.dtype == hT.dtype == torch.float32
    assert torch.equal(y, y_w) and torch.equal(hT, hT_w)
    y_ref, hT_ref = ref_scan(*(jnp.asarray(t.float().numpy())
                               for t in (delta, x, *arrs[2:])))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hT_ref), rtol=1e-4,
                               atol=1e-4)


def test_mamba_lanes_follow_the_channel_count():
    """The kernel splits a channel's states over more lanes only when
    Bt * d alone gives the card too few threads (ops.FILL_CHANNELS)."""
    from repro_torch.kernels.mamba_scan.ops import FILL_CHANNELS, default_lanes
    assert default_lanes(4, 8192) == 1                 # falcon, 4 prompts
    assert default_lanes(16, 8192) == 1
    assert default_lanes(2, 8192) == 2
    assert default_lanes(1, 8192) == 4                 # one prompt
    assert default_lanes(1, 100) == 4                  # at most 4
    assert default_lanes(1, FILL_CHANNELS - 1) == 2


# ------------------------------------------------------------ the selectors
def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    q = _t(RNG.normal(size=(1, 8, 1, 2, 16)))
    k = _t(RNG.normal(size=(1, 8, 1, 16)))
    arrs = [_t(a) for a in _scan_inputs(1, 8, 4, 4)]
    reset_launches()
    for impl in ("auto", "reference"):
        assert torch.equal(flash_attention(q, k, k, impl=impl),
                           flash_attention_ref(q, k, k))
        y, hT = mamba_scan(*arrs, impl=impl)
        y_ref, hT_ref = mamba_scan_ref(*arrs)
        assert torch.equal(y, y_ref) and torch.equal(hT, hT_ref)
    counts = launch_counts()
    assert counts["flash_attention"] == 0 and counts["mamba_scan"] == 0


def test_cuda_impl_on_a_cpu_tensor_raises():
    q = _t(RNG.normal(size=(1, 8, 1, 1, 16)))
    k = _t(RNG.normal(size=(1, 8, 1, 16)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mamba_scan(*(_t(a) for a in _scan_inputs(1, 8, 4, 4)), impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        flash_attention(q, k, k, impl="pallas")
