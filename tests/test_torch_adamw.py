"""AdamW's two routes (``train/optimizer.py``): the plain route on the CPU,
the fused kernels of ``csrc/adamw.cu`` on the card.

On the CPU: the route choice (CPU tensors take the plain route, count no
fused elements and launch nothing; the wrappers and an unknown ``impl``
raise), the pass-count
division moved into ``adamw_update`` (``grad_div``: the same bits as
dividing first, as the train step did), and a ``grad_transform`` still
seeing gradients divided by the pass count.

Marked ``cuda`` (skipped without a card; on one:  PYTHONPATH=src python
-m pytest -m cuda tests/test_torch_adamw.py): the kernels against the
plain route on the card.  At clip 0 p, m and v are bitwise the plain
route's, in fp32 and bf16 state, at leaf sizes that are not multiples of
the kernel's 4-element vectors, off 16-byte alignment, a stacked leaf and
one above ``PIECE``; the norm within rtol 1e-6 of the plain one (fp64
sums in another order against fp32 sums), its clip scale bitwise what
PyTorch computes from it; pass counts 2 and 3 bitwise against ``div_``
then the plain update; reruns bitwise; the wrappers refuse what they do
not take; a traced train step counts every parameter as fused.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.adamw import adamw_cuda, square_sums_cuda
from repro_torch.models import transformer as tf
from repro_torch.obs import trace
from repro_torch.train import optimizer, train_step as ts
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         global_norm, init_opt_state,
                                         n_fused, n_pieces, tree_leaves,
                                         tree_map)
from repro_torch.train.train_step import make_train_step


def _cfg(**kw):
    return get_config("stablelm-3b", smoke=True).replace(
        attn_impl="reference", **kw)


def _state(shapes, dtype, device, seed=0):
    """params, grads and opt state of ``shapes`` (a dict tree), drawn
    from ``seed``; v positive, the step at 3."""
    g = torch.Generator().manual_seed(seed)

    def draw(scale, positive=False):
        def one(shape):
            x = torch.randn(shape, generator=g) * scale
            return (x.abs() if positive else x).to(dtype).to(device)
        return tree_map(one, shapes)
    opt = {"m": draw(0.1), "v": draw(0.01, True),
           "step": torch.tensor(3, dtype=torch.int32, device=device)}
    return draw(1.0), draw(0.3), opt


SMALL = {"blocks": {"w": (3, 5, 4), "ln": (3, 4)}, "head_w": (4, 6),
         "final_ln": (9,)}


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _same_tree(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# --------------------------------------------------------------- the CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("div", [2, 3])
def test_grad_div_is_dividing_first(dtype, div):
    """``adamw_update(..., grad_div=k)`` on the CPU gives the bits of
    ``g.div_(k)`` then the update, the train step's order before the
    division moved into the update."""
    ocfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    out = []
    for inside in (True, False):
        p, g, opt = _state(SMALL, dtype, "cpu", seed=div)
        if inside:
            stats = adamw_update(g, p, opt, ocfg, None, grad_div=div)
        else:
            tree_map(lambda t: t.div_(div), g)
            stats = adamw_update(g, p, opt, ocfg, None)
        out.append((p, opt["m"], opt["v"], stats))
    (p1, m1, v1, s1), (p2, m2, v2, s2) = out
    assert _same_tree(p1, p2) and _same_tree(m1, m2) and _same_tree(v1, v2)
    assert torch.equal(s1["grad_norm"], s2["grad_norm"])


def test_cpu_route_counts_no_fused_elements_and_launches_nothing():
    """A traced step on the CPU counts the plain route's pieces and no
    fused element, launches no kernel, and its parameters are the bits of
    an untraced step's."""
    outs = []
    for traced in (True, False):
        cfg = _cfg(grad_accum=2)
        p = tf.init_params(cfg, seed=3, device="cpu")
        opt = init_opt_state(p, cfg)
        b = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=torch.Generator()
                                     .manual_seed(3))}
        step = make_train_step(cfg, OptConfig(warmup_steps=1))
        reset_launches()
        if traced:
            with trace.trace_scope(trace.Tracer()) as tr:
                step(p, opt, b)
            counters = tr.metrics.snapshot()["counters"]
            assert counters.get("adamw_fused_elems", 0) == 0
            assert counters["adamw_pieces"] == n_pieces(p) > 0
        else:
            step(p, opt, b)
        assert n_fused(p) == 0
        assert launch_counts()["adamw_update"] == 0
        assert launch_counts()["adamw_square_sum"] == 0
        outs.append(p)
    assert _same_tree(*outs)


def test_transform_sees_gradients_divided_by_the_pass_count(monkeypatch):
    """With a ``grad_transform`` the step still divides by the pass count
    before it (the transform sees the mean); without one AdamW gets the
    sums and the count.  An identity transform leaves the step's bits."""
    seen = {}
    real = ts.adamw_update

    def spy(grads, *a, grad_div=1, **kw):
        seen.setdefault("update", []).append(
            ([t.clone() for t in tree_leaves(grads)], grad_div))
        return real(grads, *a, grad_div=grad_div, **kw)
    monkeypatch.setattr(ts, "adamw_update", spy)

    def capture(g):
        seen["transform"] = [t.clone() for t in tree_leaves(g)]
        return g
    params = []
    for transform in (None, capture):
        cfg = _cfg(grad_accum=2)
        p = tf.init_params(cfg, seed=4, device="cpu")
        opt = init_opt_state(p, cfg)
        b = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=torch.Generator()
                                     .manual_seed(4))}
        make_train_step(cfg, OptConfig(warmup_steps=1),
                        grad_transform=transform)(p, opt, b)
        params.append(p)
    (sums, div), (means, div1) = seen["update"]
    assert (div, div1) == (2, 1)
    for s, t, m in zip(sums, seen["transform"], means):
        assert torch.equal(t, s / 2) and torch.equal(m, t)
    assert _same_tree(*params)


def test_cuda_route_refuses_cpu_tensors():
    """The kernels' wrappers refuse CPU tensors (the optimizer hands them
    only leaves on the card); ``impl`` is "auto" or "reference"."""
    p, g, opt = _state(SMALL, torch.float32, "cpu")
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA tensor"):
        adamw_cuda(p["head_w"], g["head_w"], opt["m"]["head_w"],
                   opt["v"]["head_w"], lr=one, scale=one, bc1=one, bc2=one,
                   b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        square_sums_cuda(tree_leaves(g))
    for impl in ("cuda", "triton"):
        with pytest.raises(ValueError, match="unknown adamw impl"):
            adamw_update(g, p, opt, OptConfig(), None, impl=impl)


# -------------------------------------------------------------- the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: leaves the kernels take whole: sizes that are no multiple of 4, a
#: stacked leaf, and one above PIECE (2 dims, so decayed)
CARD = {"blocks": {"w": (3, 130, 67), "ln": (3, 67)}, "head_w": (1001, 3),
        "final_ln": (7,), "big": (optimizer.PIECE // 1000 + 1, 1000)}


def _both(dev, shapes, dtype, ocfg, steps=3, div=1, seed=0):
    """``steps`` updates through the kernels and through the plain route
    on the card, from one state: [(p, m, v, stats)] each step, a pair."""
    runs = []
    for impl in ("auto", "reference"):
        p, g, opt = _state(shapes, dtype, dev, seed)
        out = []
        for k in range(steps):
            gk = tree_map(lambda t: t * (1 + k), g)
            stats = adamw_update(gk, p, opt, ocfg, None, grad_div=div,
                                 impl=impl)
            out.append((_clone(p), _clone(opt["m"]), _clone(opt["v"]),
                        stats))
        runs.append(out)
    return list(zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_kernel_update_is_the_plain_route_bitwise(dev, dtype, wd):
    ocfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.0,
                     weight_decay=wd)
    reset_launches()
    for (pk, mk, vk, sk), (pr, mr, vr, sr) in _both(dev, CARD, dtype, ocfg):
        assert _same_tree(pk, pr) and _same_tree(mk, mr)
        assert _same_tree(vk, vr)
        torch.testing.assert_close(sk["grad_norm"], sr["grad_norm"],
                                   rtol=1e-6, atol=0)
    assert launch_counts()["adamw_update"] == 3 * len(tree_leaves(CARD))


@pytest.mark.cuda
def test_kernel_update_off_vector_alignment(dev):
    """Leaves that start off 16-byte alignment take the one-element loop:
    still the plain route's bits."""
    ocfg = OptConfig(lr=1e-2, grad_clip=0.0)
    buf = [torch.randn(1 + 4099, device=dev) for _ in range(4)]
    p, g, m, v = (b[1:] for b in buf)
    v.abs_()
    p2, g2, m2, v2 = (t.clone() for t in (p, g, m, v))
    step = torch.tensor(0, dtype=torch.int32, device=dev)
    adamw_update({"x": g}, {"x": p}, {"m": {"x": m}, "v": {"x": v},
                                      "step": step.clone()}, ocfg, None)
    adamw_update({"x": g2}, {"x": p2}, {"m": {"x": m2}, "v": {"x": v2},
                                        "step": step.clone()}, ocfg, None,
                 impl="reference")
    assert all(torch.equal(a, b) for a, b in ((p, p2), (m, m2), (v, v2)))


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [0.0, 0.5, 1e6])
def test_kernel_norm_and_scale(dev, clip):
    """The norm within rtol 1e-6 of the plain one; the scale bitwise
    what PyTorch's formula gives from the kernel's norm."""
    _, g, _ = _state(CARD, torch.float32, dev)
    leaves = tree_leaves(g)
    out = square_sums_cuda(leaves, clip=clip)
    plain = global_norm(g)
    torch.testing.assert_close(out[1], plain, rtol=1e-6, atol=0)
    assert torch.equal(out[1], torch.sqrt(out[0]))
    want = (torch.clamp(clip / (out[1] + 1e-9), max=1.0) if clip > 0
            else torch.ones((), device=dev))
    assert torch.equal(out[2], want)
    assert torch.equal(square_sums_cuda(leaves, clip=clip), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("div", [2, 3])
def test_kernel_pass_count_is_div_then_plain(dev, dtype, div):
    """The kernels divide by the pass count as ``div_`` does on the card:
    bitwise at clip 0; the norm within rtol 1e-6 of the divided one."""
    ocfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.0)
    for (pk, mk, vk, sk), (pr, mr, vr, sr) in _both(
            dev, CARD, dtype, ocfg, steps=2, div=div, seed=div):
        assert _same_tree(pk, pr) and _same_tree(mk, mr)
        assert _same_tree(vk, vr)
        torch.testing.assert_close(sk["grad_norm"], sr["grad_norm"],
                                   rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_kernel_reruns_are_bitwise(dev):
    ocfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    runs = []
    for _ in range(2):
        p, g, opt = _state(CARD, torch.float32, dev, seed=7)
        stats = adamw_update(g, p, opt, ocfg, None, grad_div=3)
        runs.append((p, opt["m"], opt["v"], stats["grad_norm"]))
    (p1, m1, v1, n1), (p2, m2, v2, n2) = runs
    assert _same_tree(p1, p2) and _same_tree(m1, m2) and _same_tree(v1, v2)
    assert torch.equal(n1, n2)


@pytest.mark.cuda
def test_kernel_wrappers_refuse(dev):
    p, g, m, v = (torch.randn(8, 6, device=dev) for _ in range(4))
    one = torch.ones((), device=dev)
    kw = dict(lr=one, scale=one, bc1=one, bc2=one, b1=0.9, b2=0.95,
              eps=1e-8, wd=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        adamw_cuda(p, g.t().contiguous().t(), m, v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        square_sums_cuda([g.t()])
    with pytest.raises(ValueError, match="CUDA tensor"):
        adamw_cuda(p, g, m.cpu(), v, **kw)
    with pytest.raises(ValueError, match="shape"):
        adamw_cuda(p, g[:4], m, v, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        adamw_cuda(p, g.half(), m, v, **kw)
    with pytest.raises(ValueError, match="one float32 value"):
        adamw_cuda(p, g, m, v, **dict(kw, lr=torch.ones(2, device=dev)))
    pc, gc, oc = _state(SMALL, torch.float32, "cpu")
    pc["head_w"], gc["head_w"] = pc["head_w"].to(dev), gc["head_w"].to(dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        adamw_update(gc, pc, oc, OptConfig(), None)


@pytest.mark.cuda
def test_traced_card_step_counts_every_parameter_fused(dev):
    cfg = _cfg(grad_accum=2).replace(attn_impl="auto")
    p = tree_map(lambda t: t.to(dev), tf.init_params(cfg, seed=5,
                                                     device="cpu"))
    opt = init_opt_state(p, cfg)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64), device=dev)}
    reset_launches()
    with trace.trace_scope(trace.Tracer()) as tr:
        make_train_step(cfg, OptConfig(warmup_steps=1))(p, opt, b)
    counters = tr.metrics.snapshot()["counters"]
    assert counters["adamw_fused_elems"] == sum(
        t.numel() for t in tree_leaves(p))
    assert counters["adamw_pieces"] == 0
    assert launch_counts()["adamw_update"] == len(tree_leaves(p))
    assert launch_counts()["adamw_square_sum"] == len(tree_leaves(p)) + 1
