"""``correct`` comes out false for each fault a training cell can have,
planted under a smoke run on the CPU, and for the control: the reference
itself in the precision below the configurations' (float8 products)."""
import pytest
import torch

from portbench import check, harness
from portbench.reference.follow import follow
from portbench.tests._smoke import SEED, SMOKE_CELLS, smoke_registry


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    torch.set_num_threads(2)
    return smoke_registry(tmp_path_factory.mktemp("faults"))


def _state_unchanged(monkeypatch):
    import repro_torch.train.train_step as ts
    zero = torch.zeros(())
    monkeypatch.setattr(ts, "adamw_update",
                        lambda *a, **k: {"lr": zero, "grad_norm": zero})


def _half_batch(monkeypatch):
    import repro_torch.train.train_step as ts
    split = ts._split_microbatches

    def first_half(batch, m):
        return split({k: x[:x.shape[0] // 2] for k, x in batch.items()}, m)
    monkeypatch.setattr(ts, "_split_microbatches", first_half)


def _token_altered(monkeypatch):
    from repro_torch.data.pipeline import SequencePacker
    finish = SequencePacker.finish

    def altered(self, state):
        out = finish(self, state)
        toks = out.col("tokens")
        toks[0, 3] = 2 if toks[0, 3] != 2 else 3
        return out
    monkeypatch.setattr(SequencePacker, "finish", altered)


@pytest.mark.parametrize("cell", SMOKE_CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_fault_is_not_correct(reg, cell, fault, monkeypatch):
    fault(monkeypatch)
    result = harness.run_cell(cell, SEED, 0.2, False, "cpu", reg)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", SMOKE_CELLS)
def test_control_is_not_correct(reg, cell):
    c = reg.cell(cell)
    cj, tr = reg.config(c["config"]), reg.traffic(c["traffic"])
    ref = follow(cj, tr, SEED, c["check_steps"], "cpu")
    for variant in ({"prec": "fp8"}, {"drop_half": True}):
        got = follow(cj, tr, SEED, c["check_steps"], "cpu", **variant)
        values = dict(check.numbers(got, ref), rows_mismatch=0,
                      repeated_rows=0)
        assert not check.verdict(values, c["limits"]), variant


@pytest.mark.parametrize("cell", SMOKE_CELLS)
def test_reference_in_row_blocks_follows_the_same_steps(reg, cell):
    """``reference_rows`` splits each microbatch into blocks of rows: the
    same losses, gradients and changes to float32 rounding."""
    c = reg.cell(cell)
    cj, tr = reg.config(c["config"]), reg.traffic(c["traffic"])
    whole = follow(cj, tr, SEED, 2, "cpu")
    rows = follow(dict(cj, reference_rows=1), tr, SEED, 2, "cpu")
    values = check.numbers(rows, whole)
    assert max(values.values()) < 1e-5, values
