"""The plain versions of the backward kernels (``flash_attention_backward_ref``,
``mamba_scan_backward_ref``) against ``jax.vjp`` of the reference's plain
functions on the same numpy inputs, and the kernels' autograd Functions
with those plain backwards standing in for the kernels.

The backward kernels themselves run only on the card
(``tests/test_torch_cuda.py -k backward``); these tests hold their
formulas, the values the forwards save for them (the rows' base-2
log-sum-exp; the scan's chunk carries) and the wiring.

Tolerances, fp32: flash within rtol 1e-4 / atol 1e-5, the scan within
rtol 1e-4 / atol 1e-4 (fp32 sums in other orders: the reference's
autograd against the formulas written out).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as ref_flash
from repro.kernels.mamba_scan import mamba_scan_ref as ref_scan
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention_backward_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import LOG2E
from repro_torch.kernels.mamba_scan import (MambaScanFunction, carry_steps,
                                            mamba_scan_backward_ref,
                                            mamba_scan_ref)
from repro_torch.kernels.mamba_scan.ops import TIME_CHUNK

RNG = np.random.default_rng(25)

# the three shapes of test_torch_train's Function test, hd 80 (stablelm,
# hubert) and rows with no allowed key (Sq > Skv + window)
FLASH_CASES = [
    (2, 24, 24, 2, 2, 16, True, 0, 0.0),        # causal GQA
    (1, 32, 32, 1, 4, 8, True, 7, 5.0),         # sliding window, softcap
    (2, 17, 29, 1, 2, 8, False, 0, 0.0),        # cross-attention shapes
    (1, 40, 40, 2, 1, 80, True, 0, 0.0),        # hd 80
    (1, 30, 9, 1, 2, 16, False, 3, 0.0),        # rows fully masked
]
# the three shapes of test_torch_train's scan Function test (a ragged
# last chunk included), as (Bt, T, d, N, steps between carries)
SCAN_CASES = [(2, 32, 6, 4, 8), (1, 21, 5, 3, 8), (2, 16, 4, 2, 128)]


def _flash_inputs(B, Sq, Skv, Kh, G, hd):
    return [RNG.normal(size=s).astype(np.float32) for s in (
        (B, Sq, Kh, G, hd), (B, Skv, Kh, hd), (B, Skv, Kh, hd),
        (B, Sq, Kh, G, hd))]


@pytest.mark.parametrize("B,Sq,Skv,Kh,G,hd,causal,window,softcap",
                         FLASH_CASES)
def test_flash_backward_ref_matches_reference_vjp(B, Sq, Skv, Kh, G, hd,
                                                  causal, window, softcap):
    q, k, v, w = _flash_inputs(B, Sq, Skv, Kh, G, hd)
    opts = dict(causal=causal, window=window, softcap=softcap)
    want_out, vjp = jax.vjp(lambda a, b, c: ref_flash(a, b, c, **opts),
                            *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(w))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = flash_attention_ref(*t, return_lse=True, **opts)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=1e-6)
    got = flash_attention_backward_ref(*t, out, lse, torch.from_numpy(w),
                                       **opts)
    for name, g, ref in zip("qkv", got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


def test_flash_lse_is_the_base2_log_sum_exp_of_the_allowed_scores():
    """2^(s log2(e) - lse) sums to 1 over a row's allowed keys; a row with
    none has lse = +inf, no probability and no gradient."""
    B, Sq, Skv, Kh, G, hd = 1, 30, 9, 1, 2, 16
    q, k, v, w = (torch.from_numpy(a) for a in _flash_inputs(B, Sq, Skv, Kh,
                                                           G, hd))
    opts = dict(causal=False, window=3, softcap=0.0)
    out, lse = flash_attention_ref(q, k, v, return_lse=True, **opts)
    assert lse.shape == (B, Kh, G, Sq) and lse.dtype == torch.float32
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) / hd ** 0.5
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    allowed = kp > qp - 3
    rows = allowed.any(-1)
    p = torch.exp2(s * LOG2E - lse[..., None]).masked_fill(~allowed, 0.0)
    torch.testing.assert_close(p.sum(-1)[..., rows],
                               torch.ones_like(p.sum(-1)[..., rows]))
    assert bool(torch.isinf(lse[..., ~rows]).all()) and int((~rows).sum())
    dq, dk, dv = flash_attention_backward_ref(q, k, v, out, lse, w, **opts)
    assert bool((dq[:, ~rows] == 0).all()) and bool(torch.isfinite(dq).all())
    assert bool((out[:, ~rows] == 0).all())


@pytest.mark.parametrize("Bt,T,d,N,chunk", SCAN_CASES)
def test_scan_backward_ref_matches_reference_vjp(Bt, T, d, N, chunk):
    """All six gradients from carries a plain forward saved every
    ``chunk`` steps (and every ``carry_steps(N)``, the kernel's)."""
    delta = (np.log1p(np.exp(RNG.normal(size=(Bt, T, d)))) * 0.1)
    arrs = [a.astype(np.float32) for a in (
        delta, RNG.normal(size=(Bt, T, d)), RNG.normal(size=(Bt, T, N)),
        RNG.normal(size=(Bt, T, N)), -np.exp(RNG.normal(size=(d, N)) * 0.5),
        RNG.normal(size=(Bt, d, N)))]
    dy = RNG.normal(size=(Bt, T, d)).astype(np.float32)
    dhT = RNG.normal(size=(Bt, d, N)).astype(np.float32)
    (y_ref, h_ref), vjp = jax.vjp(ref_scan, *map(jnp.asarray, arrs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhT)))
    ts = [torch.from_numpy(a) for a in arrs]
    for ch in (chunk, None):
        y, hT, carries = mamba_scan_ref(*ts, carries=True, chunk=ch)
        steps = ch or carry_steps(N)
        assert carries.shape == (Bt, -(-T // steps), d, N)
        torch.testing.assert_close(carries[:, 0], ts[5])
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                                   atol=1e-5)
        got = mamba_scan_backward_ref(*ts, carries, torch.from_numpy(dy),
                                      torch.from_numpy(dhT), chunk=ch)
        for name, g, ref in zip(("delta", "x", "B", "C", "A", "h0"), got,
                                want):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-4,
                                       atol=1e-4, err_msg=name)


# the backward kernels' time chunks (ops.TIME_CHUNK steps): T within one,
# exactly one, and ragged over several, for every state bucket
SCAN_TIME_CASES = [(2, T, 6, N) for N in (4, 8, 16, 32)
                   for T in (50, TIME_CHUNK, 2 * TIME_CHUNK + 44)]


def _scan_case(Bt, T, d, N):
    delta = (np.log1p(np.exp(RNG.normal(size=(Bt, T, d)))) * 0.1)
    arrs = [a.astype(np.float32) for a in (
        delta, RNG.normal(size=(Bt, T, d)), RNG.normal(size=(Bt, T, N)),
        RNG.normal(size=(Bt, T, N)), -np.exp(RNG.normal(size=(d, N)) * 0.5),
        RNG.normal(size=(Bt, d, N)))]
    dy = RNG.normal(size=(Bt, T, d)).astype(np.float32)
    dhT = RNG.normal(size=(Bt, d, N)).astype(np.float32)
    return arrs, dy, dhT


@pytest.mark.parametrize("Bt,T,d,N", SCAN_TIME_CASES)
def test_scan_backward_time_chunks_match_reference_vjp(Bt, T, d, N):
    """The kernels' three passes in plain torch (each time chunk's sweep
    from a zero end, the chunks' ends chained from dhT, each chunk's walk
    from its own end) against ``jax.vjp`` of the reference (the tolerance
    above), and against the one walk (fp32 sums regrouped at the time
    chunks' ends: within rtol 1e-5 and an atol of 1e-5 times the
    gradient's largest value, as ``chip_smoke.py`` scales the long sums)."""
    arrs, dy, dhT = _scan_case(Bt, T, d, N)
    (_, _), vjp = jax.vjp(ref_scan, *map(jnp.asarray, arrs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhT)))
    ts = [torch.from_numpy(a) for a in arrs]
    _, _, carries = mamba_scan_ref(*ts, carries=True)
    dy, dhT = torch.from_numpy(dy), torch.from_numpy(dhT)
    got = mamba_scan_backward_ref(*ts, carries, dy, dhT,
                                  time_chunk=TIME_CHUNK)
    walk = mamba_scan_backward_ref(*ts, carries, dy, dhT)
    for name, g, w, ref in zip(("delta", "x", "B", "C", "A", "h0"), got,
                               walk, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-5,
            atol=1e-5 * max(1.0, float(w.abs().max())), err_msg=name)
    if T <= TIME_CHUNK:      # one time chunk: its walk is the one walk
        for g, w in zip(got[:4], walk[:4]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_scan_backward_time_chunk_is_whole_carry_intervals():
    arrs, dy, dhT = _scan_case(1, 40, 3, 16)
    ts = [torch.from_numpy(a) for a in arrs]
    _, _, carries = mamba_scan_ref(*ts, carries=True)
    with pytest.raises(ValueError, match="carry intervals"):
        mamba_scan_backward_ref(*ts, carries, torch.from_numpy(dy),
                                torch.from_numpy(dhT), time_chunk=24)


def test_scan_carries_are_the_states_before_each_chunk():
    Bt, T, d, N = 2, 37, 5, 16
    ts = [torch.from_numpy(a.astype(np.float32)) for a in (
        np.abs(RNG.normal(size=(Bt, T, d))) * 0.1, RNG.normal(size=(Bt, T, d)),
        RNG.normal(size=(Bt, T, N)), RNG.normal(size=(Bt, T, N)),
        -np.abs(RNG.normal(size=(d, N))), RNG.normal(size=(Bt, d, N)))]
    assert [carry_steps(n) for n in (1, 4, 5, 8, 9, 16, 17, 32)] == \
        [32, 32, 32, 32, 16, 16, 8, 8]
    _, _, carries = mamba_scan_ref(*ts, carries=True)
    for k, t0 in enumerate(range(0, T, 16)):
        _, h = mamba_scan_ref(*(t[:, :t0] for t in ts[:4]), *ts[4:])
        torch.testing.assert_close(carries[:, k], h)


def test_flash_function_calls_its_backward_once_and_saves_out_and_lse():
    q, k, v, w = (torch.from_numpy(a) for a in _flash_inputs(2, 24, 24, 2, 2,
                                                           16))
    q.requires_grad_(True)
    v.requires_grad_(True)
    calls = []

    def backward(*args, **kw):
        calls.append(len(args))
        return flash_attention_backward_ref(*args, **kw)
    out = FlashAttentionFunction.apply(q, k, v, True, 0, 0.0,
                                       flash_attention_ref, backward)
    saved = out.grad_fn.saved_tensors
    want_out, want_lse = flash_attention_ref(q, k, v, return_lse=True)
    assert len(saved) == 5
    torch.testing.assert_close(saved[3], want_out, rtol=0, atol=0)
    torch.testing.assert_close(saved[4], want_lse, rtol=0, atol=0)
    (out * w).sum().backward()
    assert calls == [6]                  # q, k, v, out, lse, dout
    assert q.grad is not None and v.grad is not None and k.grad is None


def test_scan_function_calls_its_backward_once_and_saves_the_carries():
    Bt, T, d, N = 2, 40, 6, 4
    ts = [torch.from_numpy(a.astype(np.float32)).requires_grad_(True)
          for a in (np.abs(RNG.normal(size=(Bt, T, d))) * 0.1,
                    RNG.normal(size=(Bt, T, d)), RNG.normal(size=(Bt, T, N)),
                    RNG.normal(size=(Bt, T, N)),
                    -np.abs(RNG.normal(size=(d, N))),
                    RNG.normal(size=(Bt, d, N)))]
    calls = []

    def backward(*args):
        calls.append(len(args))
        return mamba_scan_backward_ref(*args)
    y, hT = MambaScanFunction.apply(*ts, mamba_scan_ref, backward)
    saved = y.grad_fn.saved_tensors
    _, _, carries = mamba_scan_ref(*ts, carries=True)
    assert len(saved) == 7 and saved[6].shape == (Bt, 2, d, N)
    torch.testing.assert_close(saved[6], carries, rtol=0, atol=0)
    (y.sum() + hT.sum()).backward()
    assert calls == [9]          # six inputs, carries, grad_y, grad_hT
    with torch.enable_grad():
        want = torch.autograd.grad(
            [t.sum() for t in mamba_scan_ref(*ts)], ts)
    for t, g in zip(ts, want):
        torch.testing.assert_close(t.grad, g, rtol=1e-4, atol=1e-4)


def test_functions_pass_contiguous_output_gradients():
    """``out.sum()`` hands the backward an expanded (stride-0) gradient;
    the Functions make it contiguous, as the kernels take it."""
    seen = []

    def backward(*args, **kw):
        seen.append(args[-1].is_contiguous())
        return flash_attention_backward_ref(*args, **kw)
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _flash_inputs(1, 8, 8, 1, 1, 8))
    FlashAttentionFunction.apply(q, k, v, True, 0, 0.0, flash_attention_ref,
                                 backward).sum().backward()

    def scan_backward(*args):
        seen.extend(t.is_contiguous() for t in args[-2:])
        return mamba_scan_backward_ref(*args)
    ts = [torch.rand(s, requires_grad=True) for s in
          ((1, 8, 3), (1, 8, 3), (1, 8, 2), (1, 8, 2), (3, 2), (1, 3, 2))]
    y, hT = MambaScanFunction.apply(*ts, mamba_scan_ref, scan_backward)
    (y.sum() + hT.sum()).backward()
    assert seen == [True, True, True]


def test_bf16_flash_backward_rounds_p_for_dv_as_the_forward_does():
    """With bf16 inputs dV takes P rounded to bf16 (the forward's value
    product), and the gradients come back in bf16."""
    q, k, v, w = (torch.from_numpy(a).bfloat16() for a in _flash_inputs(
        1, 16, 16, 1, 2, 16))
    out, lse = flash_attention_ref(q, k, v, return_lse=True)
    dq, dk, dv = flash_attention_backward_ref(q, k, v, out, lse, w)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    f = functools.partial(flash_attention_backward_ref, q.float(), k.float(),
                          v.float(), out.float(), lse, w.float())
    _, _, dv32 = f()
    assert not torch.equal(dv.float(), dv32.bfloat16().float())
    torch.testing.assert_close(dv.float(), dv32, rtol=2e-2, atol=2e-2)
