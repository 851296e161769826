"""The port's sharding specs (``train/sharding.py``, ``launch/specs.py``,
``param_specs``, the cache specs, ``opt_state_specs``) against the
reference's, as tuples, in this process: all ten archs, the four profiles
(train, prefill, decode, long), the meshes (2, 2), (16, 16) and
(2, 16, 16) as objects with ``.shape`` (no devices), and the
``expert_parallel`` and ``seq_shard`` options.  Then the conversion of a
spec to DTensor placements, and the empty ``Rules`` leaving a plain tensor
alone.
"""
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import specs as ref_specs
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro.train import sharding as ref_sharding
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.layers import NO_RULES, Rules
from repro_torch.train import optimizer as opt
from repro_torch.train import sharding

MESHES = {"2x2": MeshShape((2, 2), ("data", "model")),
          "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
PROFILES = ("train", "prefill", "decode", "long")


def as_tuples(tree):
    """A reference spec tree with each ``PartitionSpec`` as a tuple."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def shapes_of(tree):
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    return tuple(tree.shape)


def both(arch, **kw):
    return (ref_configs.get_config(arch).replace(**kw),
            configs.get_config(arch).replace(**kw))


def check_cell(ref_cfg, cfg, mesh, profile):
    """Rules, param specs (raw and limited), opt specs, cache specs and
    batch specs of one (config, mesh, profile)."""
    ref_rules = ref_sharding.make_rules(mesh, profile, ref_cfg)
    rules = sharding.make_rules(mesh, profile, cfg)
    assert rules.mapping == ref_rules.mapping
    want_p = ref_tf.param_specs(ref_cfg, ref_rules)
    got_p = tf.param_specs(cfg, rules)
    assert got_p == as_tuples(want_p)
    want_lim = ref_specs.limit_specs_tree(want_p, ref_tf.param_shapes(ref_cfg),
                                          mesh)
    got_lim = specs.limit_specs_tree(got_p, tf.param_shapes(cfg), mesh)
    assert got_lim == as_tuples(want_lim)
    assert opt.opt_state_specs(got_lim) == {
        k: as_tuples(v) for k, v in ref_opt.opt_state_specs(want_lim).items()}
    for B, S in ((4, 64), (1, 32768)):
        want_c = ref_tf.make_cache_shapes(ref_cfg, B, S, ref_rules,
                                          as_spec=True)
        got_c = tf.make_cache_shapes(cfg, B, S, rules, as_spec=True)
        assert got_c == as_tuples(want_c)
        assert specs.limit_specs_tree(
            got_c, tf.make_cache_shapes(cfg, B, S, rules), mesh) == \
            as_tuples(ref_specs.limit_specs_tree(
                want_c, ref_tf.make_cache_shapes(ref_cfg, B, S, ref_rules),
                mesh))
    for kind in ("train", "prefill", "decode"):
        shape, ref_shape = (ShapeConfig("c", 64, 8, kind),
                            RefShape("c", 64, 8, kind))
        assert specs.batch_pspecs(cfg, shape, rules) == as_tuples(
            ref_specs.batch_pspecs(ref_cfg, ref_shape, ref_rules))
        assert shapes_of(specs.batch_shapes(cfg, shape)) == shapes_of(
            ref_specs.batch_shapes(ref_cfg, ref_shape))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_match_the_reference(arch, mesh):
    """Every profile at this mesh, with kv_repeat as cell_specs sets it."""
    m = MESHES[mesh]
    ref_cfg, cfg = both(arch)
    r = specs.kv_repeat_for(cfg, m.shape.get("model", 1))
    assert r == ref_specs.kv_repeat_for(ref_cfg, m.shape.get("model", 1))
    ref_cfg, cfg = both(arch, kv_repeat=r)
    for profile in PROFILES:
        check_cell(ref_cfg, cfg, m, profile)
    assert sharding.data_axis_size(m) == ref_sharding.data_axis_size(m)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,option", [
    ("mixtral-8x7b", "expert_parallel"), ("grok-1-314b", "expert_parallel"),
    ("stablelm-3b", "seq_shard"), ("qwen2-72b", "seq_shard")])
def test_specs_with_options_match_the_reference(arch, option, mesh):
    ref_cfg, cfg = both(arch, **{option: True})
    for profile in PROFILES:
        check_cell(ref_cfg, cfg, MESHES[mesh], profile)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_kv_repeat_and_limit_spec_match_the_reference(arch):
    ref_cfg, cfg = both(arch)
    for n in (1, 2, 4, 8, 16, 32):
        assert specs.kv_repeat_for(cfg, n) == ref_specs.kv_repeat_for(
            ref_cfg, n)
    m = MESHES["2x16x16"]
    for spec, shape in [(("model", ("pod", "data")), (cfg.vocab_size, 64)),
                        (("model", None), (504, 8)), ((None, "data"), (3, 32)),
                        ((("pod", "data", "model"),), (512,)), ((), (4,))]:
        from jax.sharding import PartitionSpec as P
        assert specs.limit_spec(spec, shape, m) == tuple(
            ref_specs.limit_spec(P(*spec), shape, m))


@pytest.mark.parametrize("arch", ["stablelm-3b", "mixtral-8x7b",
                                  "falcon-mamba-7b", "hubert-xlarge"])
def test_cell_specs_hold_the_limited_specs_and_placements(arch):
    """cell_specs at the production mesh: the limited specs of the
    reference's composition, placements from them, and opt / cache / batch
    entries for their kinds."""
    m = MESHES["16x16"]
    cfg = configs.get_config(arch)
    for kind in ("train", "decode"):
        cell = specs.cell_specs(cfg, ShapeConfig("c", 4096, 256, kind), m)
        assert cell["profile"] == kind
        ref_cfg = ref_configs.get_config(arch).replace(
            kv_repeat=cell["cfg"].kv_repeat)
        ref_rules = ref_sharding.make_rules(m, kind, ref_cfg)
        assert cell["param_specs"] == as_tuples(ref_specs.limit_specs_tree(
            ref_tf.param_specs(ref_cfg, ref_rules),
            ref_tf.param_shapes(ref_cfg), m))
        head = cell["param_specs"]["head_w"]
        assert cell["param_placements"]["head_w"] == \
            sharding.placements(head, m)
        assert ("opt_specs" in cell) == (kind == "train")
        assert ("cache_specs" in cell) == (kind == "decode")
    long = specs.cell_specs(cfg, ShapeConfig("l", 524288, 1, "decode"), m)
    assert long["profile"] == "long"


def test_spec_to_placements():
    m = MESHES["2x16x16"]
    assert sharding.placements((None, "model"), m) == (
        Replicate(), Replicate(), Shard(1))
    # a dim over (pod, data): both mesh dims shard it, pod outermost
    assert sharding.placements((("pod", "data"), "model"), m) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), m)         # not mesh order
    with pytest.raises(ValueError):
        sharding.placements(("model", "model"), m)
    # limited: hubert's vocab 504 does not divide over 16
    assert sharding.spec_placements(("model", None), (504, 8), m) == (
        Replicate(),) * 3
    assert sharding.axis_size(m, ("pod", "data")) == 32


def test_empty_rules_leave_a_plain_tensor_alone():
    x = torch.arange(12.0).reshape(3, 4)
    assert NO_RULES.cons(x, "batch", None) is x
    assert NO_RULES.spec("batch", "vocab") == (None, None)
    rules = sharding.make_rules(MESHES["2x2"], "train")
    assert rules.mesh is None            # a shape object: specs only
    assert rules.cons(x, "batch", "vocab") is x
    assert rules.spec("batch", "vocab", None, "layers") == (
        "data", "model", None, None)
    assert Rules({"batch": "data"}).spec() == ()


@pytest.mark.parametrize("args", [(10.0, 4, 0.01, 64), (1.0, 4, 10.0, 64),
                                  (1000.0, 2, 1e-6, 16), (5.0, 1, 0.0, 8)])
def test_plan_microbatches_matches_the_reference(args):
    from repro.train.pipeline_parallel import plan_microbatches as ref_plan
    from repro_torch.train.pipeline_parallel import plan_microbatches
    assert plan_microbatches(*args) == ref_plan(*args)


def test_parse_mesh_and_the_nccl_world_check(monkeypatch):
    """``--mesh`` parsing, and a world larger than the visible cards under
    nccl raising before any process group is made (never falling back to
    gloo)."""
    from repro_torch.launch import mesh as mesh_mod
    assert mesh_mod.parse_mesh("model=2,data=4") == {"data": 4, "model": 2}
    assert mesh_mod.parse_mesh("pod=2,data=2,model=2") == {
        "pod": 2, "data": 2, "model": 2}
    with pytest.raises(ValueError):
        mesh_mod.parse_mesh("data=two")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 cards, 1 visible"):
        mesh_mod.init_distributed(None, "cuda")
