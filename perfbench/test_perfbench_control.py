"""The comparison that decides ``correct`` fails its control and its
faults, at a size a test run holds (the toy cells, on the CPU).

The control is the plain reference computed with float8 operands, one
step below the bf16 the configurations state, read at the same prompts
and served tokens; the harness holds it to the cell's limits and it has
to fail one of them.  Each fault is planted in the timed path underneath
a whole run, which has to come out not correct: in the dense toy cells
(granite's kind of check) and in the MoE toy cells (grok's: the worst
prompt's or slot's row errors).  An altered single token or answer, and
one slot's fault, are the dense cells' to catch (``top1_gap_max``,
``token_gap_max``): in a MoE cell bf16 routing near-ties move single
tokens, and the rows of a slot, as far (see PERF.md)."""
import pytest

from perfbench import testing

SECONDS = {"toy.toy_prefill": 0.0, "toy.toy_decode": 5.0,
           "toy_moe.toy_prefill": 0.0, "toy_moe.toy_decode": 5.0}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return testing.toy_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(SECONDS))
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102])
def test_the_control_fails_and_the_program_passes(toy, cell, seed):
    rc, result, err = testing.run_cell(toy, cell, seed=seed,
                                       seconds=SECONDS[cell], control=True)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    # the harness holds the control to the cell's limits itself
    assert result["control_correct"] is False, result["control"]
    failed = [name for name, c in result["checks"].items()
              if result["control"].get(name, 0.0) > c["limit"]]
    assert failed, (result["control"], result["checks"])
    assert any(line.startswith("control ") for line in err.splitlines())


@pytest.mark.parametrize("cell,fault", [
    ("toy.toy_prefill", "answer"),
    ("toy.toy_prefill", "half_positions"),
    ("toy.toy_decode", "token"),
    ("toy.toy_decode", "state"),
    ("toy.toy_decode", "session"),
    ("toy.toy_decode", "half"),
    ("toy.toy_decode", "slot"),
    # grok's kind of cell: its worst prompt's or slot's row errors
    ("toy_moe.toy_prefill", "half_positions"),
    ("toy_moe.toy_decode", "state"),
    ("toy_moe.toy_decode", "session"),
    ("toy_moe.toy_decode", "half")])
def test_a_fault_in_the_timed_path_is_not_correct(toy, cell, fault):
    rc, result, err = testing.run_cell(toy, cell, seconds=SECONDS[cell],
                                       fault=fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]
