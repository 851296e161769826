"""The dry run (``repro_torch.launch.{dryrun,op_cost,roofline}``) on the
CPU: the op counter on programs whose counts are known, the kernels' fake
ops and FLOP formulas, ``model_flops_for`` against the reference's, and
traces on torch's fake process group.

The fake group is process-global, so every case that needs it runs in one
subprocess (``PORT_PROG``), beside a subprocess of the reference on 4 XLA
host devices (``REF_PROG``), as ``test_dryrun_path.py`` runs it; the two
run at once and each test reads its part of their results.  Counts are
exact (integers); no tolerance is used.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config, get_shapes
from repro_torch.kernels.flash_attention import flash_attention_backward_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mamba_scan import (mamba_scan_backward_ref,
                                            mamba_scan_ref)
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.launch.op_cost import OpCounter, wire_bytes
from repro_torch.launch.roofline import model_flops_for

RNG = np.random.default_rng(11)


def _f32(*shape):
    return torch.from_numpy(RNG.normal(size=shape).astype(np.float32))


def _row(counter, op):
    return next(r for r in counter.rows() if r["op"] == op)


# ---------------------------------------------------------------------------
#  The counter on known programs (no process group)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_matmul_counts_2mnk_and_its_operands_and_result(device):
    M, K, N = 48, 40, 24
    a, b = _f32(M, K).to(device), _f32(K, N).to(device)
    with OpCounter() as c:
        a @ b
    t = c.totals()
    assert t["flops"] == 2 * M * N * K
    assert t["hbm_bytes"] == 4 * (M * K + K * N + M * N)
    assert c.peak_bytes == 4 * M * N


def test_a_loop_of_layers_counts_each_layer():
    L, d = 7, 32
    x, w = _f32(4, d), _f32(d, d)
    with OpCounter() as one:
        x @ w
    with OpCounter() as loop:
        h = x
        for _ in range(L):
            h = h @ w
    assert loop.totals()["flops"] == L * one.totals()["flops"]
    assert _row(loop, "aten.mm")["calls"] == L
    # each layer's output dies with the next: two alive at most
    assert loop.peak_bytes == 2 * 4 * 4 * d


def test_views_count_no_bytes_and_copy_reads_only_its_source():
    x = _f32(8, 6, 4)
    with OpCounter() as c:
        x.view(48, 4).t()
        x[2]
        x.transpose(0, 1)
        x.reshape(8, 24)
    assert c.totals()["hbm_bytes"] == 0 and c.peak_bytes == 0
    dst = torch.empty(8, 6, 4)
    with OpCounter() as c:
        dst.copy_(x)
        dst.zero_()
    assert _row(c, "aten.copy_")["bytes"] == 2 * 4 * x.numel()
    assert _row(c, "aten.zero_")["bytes"] == 4 * x.numel()


@pytest.mark.parametrize("kind,g,result_bytes,want", [
    ("all-gather", 16, 1024, 1024 * 15 / 16),          # operand 64
    ("all-reduce", 16, 1024, 2 * 1024 * 15 / 16),
    ("reduce-scatter", 16, 64, 15 * 64),               # operand 1024
    ("all-to-all", 16, 1024, 1024 * 15 / 16),
    ("collective-permute", 2, 512, 512),
])
def test_ring_wire_bytes(kind, g, result_bytes, want):
    operand = {"all-gather": result_bytes / g,
               "reduce-scatter": result_bytes * g}.get(kind, result_bytes)
    assert wire_bytes(kind, operand, g) == want
    assert wire_bytes(kind, operand, 1) == 0


# ---------------------------------------------------------------------------
#  The kernels' ops on meta tensors
# ---------------------------------------------------------------------------
def _pairs_by_mask(Sq, Skv, causal, window):
    qp, kp = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return int(mask.sum())


@pytest.mark.parametrize("causal,window,Sq,Skv", [
    (True, 0, 96, 96), (True, 24, 96, 96), (False, 0, 40, 72),
    (False, 16, 64, 64)])
def test_flash_fake_op_shapes_and_flops(causal, window, Sq, Skv,
                                        monkeypatch):
    monkeypatch.setattr(flash_ops, "flash_attention_ref",
                        lambda *a, **k: pytest.fail("plain version ran"))
    B, Kh, G, hd = 2, 3, 2, 32
    q = torch.empty(B, Sq, Kh, G, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Skv, Kh, hd, dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as fc, OpCounter() as c:
        out = flash_ops.flash_attention(q, k, k, causal=causal,
                                        window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta"
    want = 4 * hd * B * Kh * G * _pairs_by_mask(Sq, Skv, causal, window)
    assert fc.get_total_flops() == want
    assert c.totals()["flops"] == want
    assert _row(c, "repro_torch.flash_attention")["calls"] == 1
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(q[..., :20], k[..., :20], k[..., :20])


def test_scan_fake_op_matches_the_plain_forward_count(monkeypatch):
    Bt, T, d, N = 2, 32, 8, 4
    ins = (_f32(Bt, T, d).abs() * 0.1, _f32(Bt, T, d), _f32(Bt, T, N),
           _f32(Bt, T, N), -_f32(d, N).abs(), _f32(Bt, d, N))
    with FlopCounterMode(display=False) as plain:
        mamba_scan_ref(*ins)
    monkeypatch.setattr(scan_ops, "mamba_scan_ref",
                        lambda *a: pytest.fail("plain version ran"))
    with FlopCounterMode(display=False) as fake:
        y, hT = scan_ops.mamba_scan(*(t.to("meta") for t in ins))
    assert (tuple(y.shape), tuple(hT.shape)) == ((Bt, T, d), (Bt, d, N))
    assert y.dtype == hT.dtype == torch.float32
    assert fake.get_total_flops() == plain.get_total_flops() == \
        2 * Bt * T * d * N


@pytest.mark.parametrize("needs", [
    (True, True, True, True, True, False), (True,) * 6,
    (True, False, False, False, False, False)])
@pytest.mark.parametrize("chunk", [16, 10])
def test_scan_backward_closed_form_equals_the_plain_backward(needs, chunk):
    """The backward op's FLOPs, as ``MambaScanFunction`` runs it on meta
    tensors, against ``FlopCounterMode`` over the plain version of the
    backward kernel (``mamba_scan_backward_ref``, carries every ``chunk``
    steps) at T 32; the plain backward never runs on meta tensors."""
    Bt, T, d, N = 2, 32, 8, 4
    ins = [_f32(Bt, T, d).abs() * 0.1, _f32(Bt, T, d), _f32(Bt, T, N),
           _f32(Bt, T, N), -_f32(d, N).abs(), _f32(Bt, d, N)]
    _, _, carries = mamba_scan_ref(*ins, carries=True, chunk=chunk)
    with FlopCounterMode(display=False) as plain:
        mamba_scan_backward_ref(*ins, carries, torch.ones(Bt, T, d),
                                torch.ones(Bt, d, N), chunk=chunk)
    meta = [t.detach().to("meta").requires_grad_(n)
            for t, n in zip(ins, needs)]
    y, hT = scan_ops.MambaScanFunction.apply(
        *meta, scan_ops._mamba_scan_op, scan_ops._mamba_scan_backward_op)
    with FlopCounterMode(display=False) as fake:
        grads = torch.autograd.grad((y, hT), [t for t in meta
                                              if t.requires_grad],
                                    (torch.ones_like(y), torch.ones_like(hT)))
    assert fake.get_total_flops() == plain.get_total_flops() == \
        8 * Bt * T * d * N
    assert [g.shape for g in grads] == [t.shape for t in meta
                                        if t.requires_grad]


@pytest.mark.parametrize("causal,window,Sq,Skv", [
    (True, 0, 96, 96), (True, 24, 96, 96), (False, 0, 40, 72),
    (False, 16, 64, 64)])
def test_flash_backward_op_counts_the_kernels_products(causal, window, Sq,
                                                       Skv, monkeypatch):
    """The backward op's FLOPs, as ``FlashAttentionFunction`` runs it on
    meta tensors: 14·hd on each pair the mask allows plus 2·hd a query
    row, a query head; no plain version runs.  The plain backward
    (``flash_attention_backward_ref``) counts its five products over the
    full square, 10·hd a pair, plus D's 2·hd a row."""
    B, Kh, G, hd = 2, 3, 2, 32
    rows, pairs = B * Kh * G, _pairs_by_mask(Sq, Skv, causal, window)
    kw = dict(causal=causal, window=window)
    q, k, v, do = (_f32(B, S, Kh, G, hd) if i in (0, 3) else _f32(B, S, Kh,
                                                                   hd)
                   for i, S in enumerate((Sq, Skv, Skv, Sq)))
    out, lse = flash_ops.flash_attention_ref(q, k, v, return_lse=True, **kw)
    with FlopCounterMode(display=False) as plain:
        flash_attention_backward_ref(q, k, v, out, lse, do, **kw)
    assert plain.get_total_flops() == rows * hd * (10 * Sq * Skv + 2 * Sq)
    monkeypatch.setattr(flash_ops, "flash_attention_ref",
                        lambda *a, **k: pytest.fail("plain version ran"))
    meta = [t.to(torch.bfloat16).to("meta").requires_grad_(True)
            for t in (q, k, v)]
    out = flash_ops.flash_attention(*meta, **kw)
    with FlopCounterMode(display=False) as fake, OpCounter() as c:
        grads = torch.autograd.grad(out, meta, torch.ones_like(out))
    assert fake.get_total_flops() == c.totals()["flops"] == \
        rows * hd * (14 * pairs + 2 * Sq)
    assert _row(c, "repro_torch.flash_attention_backward")["calls"] == 1
    assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype)
                                                   for t in meta]


# ---------------------------------------------------------------------------
#  model_flops_for against the reference's, every (arch x shape) cell
# ---------------------------------------------------------------------------
CELLS = [(a, s) for a in ARCH_IDS for s in get_shapes(a)]


def test_there_are_32_cells():
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_for_equals_the_reference(arch, shape):
    from repro.configs import get_config as ref_config
    from repro.configs import get_shapes as ref_shapes
    from repro.launch.hlo_analysis import model_flops_for as ref_flops
    assert model_flops_for(get_config(arch), get_shapes(arch)[shape]) == \
        ref_flops(ref_config(arch), ref_shapes(arch)[shape])


# ---------------------------------------------------------------------------
#  On the fake process group (one subprocess) and the reference (another)
# ---------------------------------------------------------------------------
PORT_PROG = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh, \\
        make_fake_production_mesh
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.specs import cell_specs
    from repro_torch.models.layers import on_shards
    from repro_torch.train.sharding import from_local_shard, local_window
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.models.layers import reshape
    out = {}
    mesh = make_fake_production_mesh()
    prop = DTensor._op_dispatcher.sharding_propagator
    before = (prop.propagate_op_sharding, dict(prop.__dict__))

    def dt(shape, plc):
        loc, _ = local_window(shape, mesh, plc)
        return from_local_shard(torch.empty(loc, device="meta"), mesh, plc,
                                shape)
    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    a, b = dt((1024, 4096), (S0, R)), dt((4096, 8192), (R, S1))
    with OpCounter() as c:
        y = a @ b
    out["sharded"] = [c.totals()["flops"], list(y.to_local().shape)]
    ra, rb = dt((64, 4096), (R, R)), dt((4096, 4096), (R, R))
    with OpCounter() as c:
        ra @ rb
    out["replicated"] = c.totals()["flops"]
    with OpCounter() as c:
        on_shards(torch.matmul, (a, b), ((S0, R), (R, S1)), (S0, S1))
    out["local_map"] = c.totals()["flops"]
    x = dt((4096, 512), (R, S0))
    with OpCounter() as c:
        x.redistribute(mesh, (R, R)).to_local()
    t = c.totals()
    out["all_gather"] = [t["wire_bytes"], t["operand_bytes"],
                         t["counts"]]
    out["propagator_restored"] = (
        prop.propagate_op_sharding is before[0]
        and set(prop.__dict__) == set(before[1]))
    # the fused head dim over 'model' 16: 8 heads are gathered first,
    # 16 keep their shard
    h = dt((4, 1024), (R, S1))
    out["reshape"] = [[repr(p) for p in y.placements]
                      + [list(y.to_local().shape)]
                      for y in (reshape(h, (4, 8, 128)),
                                reshape(h, (4, 16, 64)))]

    # stablelm-3b decode_32k at full width on 16x16, its record saved and
    # priced again from its op table
    import tempfile
    from repro_torch.configs import get_shapes
    dryrun.ARTIFACT_DIR = tempfile.mkdtemp()
    rec = dryrun.run_cell("stablelm-3b", "decode_32k", verbose=False)
    with open(f"{dryrun.ARTIFACT_DIR}/stablelm-3b_decode_32k_16x16.json",
              "w") as f:
        json.dump(dict(rec, roofline={"n_devices": 256,
                                      "model_flops": 1.0}), f)
    dryrun.reanalyze_artifacts()
    with open(f"{dryrun.ARTIFACT_DIR}/stablelm-3b_decode_32k_16x16.json"
              ) as f:
        again = json.load(f)["roofline"]
    shape = get_shapes("stablelm-3b")["decode_32k"]
    specs = cell_specs(get_config("stablelm-3b"), shape, mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def hand(shapes, spec_tree):
        total = 0
        for x, sp in zip(tree_leaves(shapes), tree_leaves(spec_tree)):
            n = x.element_size()
            for i, d in enumerate(x.shape):
                e = sp[i] if i < len(sp) else None
                axes = () if e is None else (e if isinstance(e, tuple)
                                             else (e,))
                div = 1
                for ax in axes:
                    div *= sizes[ax]
                n *= d // div
            total += n
        return total
    cache = dict(specs["cache_shapes"])
    cache_spec = dict(specs["cache_specs"])
    del cache["pos_idx"], cache_spec["pos_idx"]
    out["decode"] = {
        "args": rec["memory"]["argument_bytes_by_kind"],
        "hand_params": hand(specs["param_shapes"], specs["param_specs"]),
        "hand_cache": hand(cache, cache_spec),
        "hand_batch": hand(specs["batch_shapes"], specs["batch_specs"]),
        "roofline": rec["roofline"], "again": again,
        "peak": rec["memory"]["trace_peak_bytes"]}

    # the reference's own dry-run cell: mixtral smoke, tiny_train, 2x2
    mesh4 = make_fake_mesh((2, 2), ("data", "model"))
    scfg = get_config("mixtral-8x7b", smoke=True).replace(grad_accum=2)
    tiny = ShapeConfig("tiny_train", seq_len=32, global_batch=8,
                       kind="train", grad_accum=2)
    r4 = dryrun.trace_step(scfg, tiny, mesh4)
    out["tiny"] = {"args": r4["args"],
                   "flops": r4["counter"].totals()["flops"],
                   "alias": r4["alias_bytes"]}

    # qwen2.5-32b x train_4k on 2x16x16, cut to one layer at full width:
    # a microbatch of 16 sequences does not split over 32 batch ranks, so
    # two run as one pass, each rank one sequence of it
    import repro_torch.train.train_step as ts
    rows, fwd = [], ts.forward_train

    def spy(params, batch, cfg, rules, **kw):
        rows.append(list(batch["tokens"].to_local().shape))
        return fwd(params, batch, cfg, rules, **kw)
    ts.forward_train = spy
    cut = get_config("qwen2.5-32b").replace(n_layers=1)
    shape = get_shapes("qwen2.5-32b")["train_4k"]
    mesh512 = make_fake_production_mesh(multi_pod=True)
    r = dryrun.trace_step(cut, shape, mesh512)
    ts.forward_train = fwd
    out["multi_pod"] = {
        "rows": rows, "accum": r["cfg"].grad_accum,
        "batch": shape.global_batch, "seq": shape.seq_len,
        "peak": dryrun.record(r, r["cfg"], shape, 512)["memory"][
            "peak_bytes_per_device"]}
    print("PORT_JSON " + json.dumps(out))
""")

REF_PROG = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch.jax_compat import axis_types_kwargs, set_mesh
    from repro.launch.specs import cell_specs
    from repro.train.optimizer import OptConfig
    from repro.train.train_step import make_train_step
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4], **axis_types_kwargs(2))
    cfg = get_config("mixtral-8x7b", smoke=True).replace(grad_accum=2)
    shape = ShapeConfig("tiny_train", seq_len=32, global_batch=8,
                        kind="train", grad_accum=2)
    specs = cell_specs(cfg, shape, mesh)
    cfg = specs["cfg"]
    step = make_train_step(cfg, OptConfig(), specs["rules"])
    with set_mesh(mesh):
        fn = jax.jit(step,
                     in_shardings=(specs["param_shardings"],
                                   specs["opt_shardings"],
                                   specs["batch_shardings"]),
                     out_shardings=(specs["param_shardings"],
                                    specs["opt_shardings"], None),
                     donate_argnums=(0, 1))
        lowered = fn.lower(specs["param_shapes"], specs["opt_shapes"],
                           specs["batch_shapes"])
    mem = lowered.compile().memory_analysis()
    print("REF_JSON " + json.dumps({
        "args": int(mem.argument_size_in_bytes),
        "tokens_dtype": str(specs["batch_shapes"]["tokens"].dtype)}))
""")


@pytest.fixture(scope="module")
def runs():
    env = {**os.environ, "PYTHONPATH": "src"}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", prog], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for name, prog in (("PORT", PORT_PROG), ("REF", REF_PROG))}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        line = next((x for x in stdout.splitlines()
                     if x.startswith(name + "_JSON ")), None)
        assert line is not None, stdout + stderr
        out[name] = json.loads(line.split(" ", 1)[1])
    return out


def test_a_sharded_matmul_counts_one_device_share(runs):
    """(data, model)-sharded [1024, 4096] @ [4096, 8192] on 16 x 16: one
    device's local product, 1/256 of the global count, with nothing of
    DTensor's shape propagation (the global product on fake tensors)."""
    flops, local_shape = runs["PORT"]["sharded"]
    assert local_shape == [64, 512]
    assert flops == 2 * 1024 * 4096 * 8192 // 256


def test_a_replicated_matmul_counts_whole(runs):
    assert runs["PORT"]["replicated"] == 2 * 64 * 4096 * 4096


def test_work_inside_local_map_counts_once(runs):
    assert runs["PORT"]["local_map"] == 2 * 1024 * 4096 * 8192 // 256


def test_an_all_gather_over_g_ranks(runs):
    """[4096, 512] sharded over 'model' (g 16) gathered whole: one
    all-gather of a 256 x 512 fp32 operand, (g-1)/g of the result on the
    wire."""
    wire, operand, counts = runs["PORT"]["all_gather"]
    result = 4096 * 512 * 4
    assert counts == {"all-gather": 1}
    assert operand == {"all-gather": result / 16}
    assert wire == {"all-gather": result * 15 / 16}


def test_the_counter_restores_the_sharding_propagator(runs):
    assert runs["PORT"]["propagator_restored"]


def test_a_head_split_the_shards_do_not_divide_is_gathered_first(runs):
    gathered, kept = runs["PORT"]["reshape"]
    assert gathered == ["Replicate()", "Replicate()", [4, 8, 128]]
    assert kept == ["Replicate()", "Shard(dim=1)", [4, 1, 64]]


@pytest.mark.parametrize("src,dst,want", [
    ((4, 32, 1024), (4, 32, 8, 128), {2: 8}),
    ((65536, 6144), (16, 4096, 6144), {0: 16}),
    ((16, 4096, 6144), (65536, 6144), {}),
    ((4, 8), (4, 1, 8), {1: 8})])
def test_split_dims(src, dst, want):
    from repro_torch.models.layers import _split_dims
    assert _split_dims(src, dst) == want


def test_stablelm_decode_arguments_are_the_local_shards(runs):
    d = runs["PORT"]["decode"]
    assert d["args"]["params"] == d["hand_params"]
    assert d["args"]["cache"] == d["hand_cache"]
    assert d["args"]["batch"] == d["hand_batch"]
    # 32 layers of k and v, [128 / 16, 32768, 32 / 16, 80] bf16 a device
    assert d["hand_cache"] == 32 * 2 * 8 * 32768 * 2 * 80 * 2


def test_stablelm_decode_moves_bytes_and_collectives(runs):
    r = runs["PORT"]["decode"]["roofline"]
    counts = r["collective_count_by_kind"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert counts.get("all-gather", 0) > 0
    assert counts.get("all-reduce", 0) + counts.get("reduce-scatter", 0) > 0
    assert all(v > 0 for v in r["collective_bytes_by_kind"].values())
    assert runs["PORT"]["decode"]["peak"] > 0


def test_a_saved_cell_is_priced_again_from_its_op_table(runs):
    """``reanalyze_artifacts`` rebuilds the roofline from the stored op
    table alone (the record's roofline was overwritten before)."""
    d = runs["PORT"]["decode"]
    keys = ("flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collective_bytes_by_kind",
            "collective_count_by_kind", "t_compute_s", "t_memory_s",
            "t_collective_s", "bottleneck")
    assert {k: d["again"][k] for k in keys} == \
        {k: d["roofline"][k] for k in keys}
    assert d["again"]["model_flops"] == 1.0


def test_tiny_train_argument_bytes_equal_the_reference(runs):
    """mixtral smoke, tiny_train, 2 x 2: params and opt state bytes a
    device equal the reference's ``memory_analysis()``.  By design the
    port's token ids are int64 where the reference's are int32
    (``launch/specs.batch_shapes``): the batch argument is twice the
    reference's, [8 / 2, 32] tokens a device."""
    port, ref = runs["PORT"]["tiny"]["args"], runs["REF"]["args"]
    assert runs["REF"]["tokens_dtype"] == "int32"
    tokens = 8 // 2 * 32
    assert port["batch"] == tokens * 8
    assert port["params"] + port["opt_state"] + tokens * 4 == ref
    # the step updates params and opt state in place
    assert runs["PORT"]["tiny"]["alias"] == port["params"] + \
        port["opt_state"]
    assert runs["PORT"]["tiny"]["flops"] > 0


def test_a_microbatch_the_batch_axes_do_not_divide_is_split(runs):
    """16 sequences a microbatch over the 32 ranks of (pod, data): the
    step runs two microbatches a pass, so each rank's local batch is one
    sequence, not the whole microbatch, and one full-width layer's step
    fits a card."""
    d = runs["PORT"]["multi_pod"]
    mb = d["batch"] // d["accum"]
    assert mb == 16 and 32 % mb == 0
    assert d["rows"] == [[1, d["seq"]]] * (d["accum"] // 2)
    assert d["peak"] < 80 * 2**30
