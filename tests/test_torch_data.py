"""The port's LM input pipeline (``repro_torch.data``) against the
reference's (``repro.data``): the ETL dataflow on the port's own core, run
on the ``numpy`` backend as the reference runs it, gives byte-identical
token blocks; the family batch functions give identical arrays; the
prefetch queue yields everything, propagates errors, and its ``close``
ends the producer thread.  Exact comparisons throughout (integer tokens,
the same numpy draws)."""
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data import InputPipeline as RefInputPipeline
from repro.data import PipelineConfig as RefPipelineConfig
from repro.data import make_lm_batch_fn as ref_batch_fn
from repro_torch.configs import get_config
from repro_torch.core import partition
from repro_torch.core.shared_cache import SharedCache
from repro_torch.data import (InputPipeline, PipelineConfig, PrefetchQueue,
                              SyntheticTokenSource, make_lm_batch_fn)
from repro_torch.data.pipeline import SequencePacker, build_lm_dataflow


def _kw(**over):
    kw = dict(seq_len=64, global_batch=4, vocab_size=500,
              docs_per_window=128, num_splits=4, pipeline_degree=2,
              max_doc_len=96, min_doc_len=8, seed=3)
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    {"docs_per_window": 24},                     # several blocks a window
    {"docs_per_window": 4, "global_batch": 8},   # a batch over many windows
    {"docs_per_window": 24, "seq_len": 200, "num_splits": 3, "seed": 11},
])
def test_blocks_byte_identical_to_reference(over):
    """Across window boundaries: the packer's leftover carries into the
    next window's first block in both."""
    ref = RefInputPipeline(RefPipelineConfig(**_kw(**over)))
    port = InputPipeline(PipelineConfig(**_kw(**over)))
    r, p = iter(ref), iter(port)
    for i in range(6):
        a, b = next(r), next(p)
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, i
        np.testing.assert_array_equal(b, a, err_msg=f"batch {i}")
    assert len(port.engine_runs) == len(ref.engine_runs) >= 2
    np.testing.assert_array_equal(port._carry, ref._carry)


def test_pipeline_runs_on_the_numpy_backend():
    """The host dataflow names the numpy backend (the port's default is
    the card): its blocks are numpy arrays, made without a device."""
    pipe = InputPipeline(PipelineConfig(**_kw()))
    blk = next(iter(pipe))
    assert isinstance(blk, np.ndarray)
    assert pipe.engine_runs[0].backend == "numpy"


def test_dataflow_partitions_into_two_trees():
    flow, _, _ = build_lm_dataflow(PipelineConfig(**_kw()), window=0)
    roots = {t.root for t in partition(flow).trees}
    assert roots == {"doc_source", "sequence_packer"}


def test_packer_block_component_semantics():
    p = SequencePacker("p", seq_len=4, eos_id=9)
    state = p.new_state()
    for toks, n in (([1, 2, 3, 0], 3), ([4, 5, 0, 0], 2)):
        p.accumulate(state, SharedCache({
            "tokens": np.array([toks], np.int32),
            "length": np.array([n], np.int32)}))
    out = p.finish(state)
    np.testing.assert_array_equal(out.col("tokens"), [[1, 2, 3, 9, 4]])
    np.testing.assert_array_equal(p.leftover, [5, 9])


def test_source_chunks_are_the_reference_draws():
    from repro.data import SyntheticTokenSource as RefSource
    kw = _kw()
    a = list(RefSource("s", RefPipelineConfig(**kw), 2).chunks(40))
    b = list(SyntheticTokenSource("s", PipelineConfig(**kw), 2).chunks(40))
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        for c in ("tokens", "length"):
            np.testing.assert_array_equal(y.col(c), x.col(c))


@pytest.mark.parametrize("arch", ["stablelm-3b", "falcon-mamba-7b",
                                  "mixtral-8x7b", "hubert-xlarge",
                                  "llama-3.2-vision-11b"])
def test_batch_fns_match_reference(arch):
    blk = (np.arange(4 * 33, dtype=np.int32).reshape(4, 33) * 37) % 1000
    want = ref_batch_fn(ref_get_config(arch, smoke=True))(blk)
    got = make_lm_batch_fn(get_config(arch, smoke=True))(blk)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_prefetch_queue_yields_all_and_propagates_errors():
    q = PrefetchQueue(iter(range(10)), depth=2, stage_fn=lambda x: x * 2)
    assert sorted(q) == [0, 2, 4, 6, 8, 10, 12, 14, 16, 18]

    def boom():
        yield 1
        raise ValueError("source died")

    q2 = PrefetchQueue(boom(), depth=2)
    assert next(q2) == 1
    with pytest.raises(ValueError, match="source died"):
        next(q2)
        next(q2)


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_close_ends_the_producer(depth):
    """A producer blocked on a full queue leaves once closed."""
    q = PrefetchQueue(iter(range(1000)), depth=depth)
    assert next(q) == 0
    q.close()
    assert not q._thread.is_alive()
