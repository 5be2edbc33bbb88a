"""The port's model examples (``examples_torch/quickstart.py``,
``serve_replicated.py``, ``train_e2e.py``) against the JAX package's: each
script run as a subprocess on the CPU prints the same lines with their
numbers and token ids masked (the parameters are drawn by different
generators, so the values differ).  ``train_e2e`` runs at ``--steps 30
--d-model 64``, and its own bitwise-resume assertion must hold in the
port."""
import pytest

from test_torch_examples import masked, run_example

pytestmark = pytest.mark.torch

MODEL_EXAMPLES = {"quickstart": (), "serve_replicated": (),
                  "train_e2e": ("--steps", "30", "--d-model", "64")}


@pytest.mark.parametrize("name", list(MODEL_EXAMPLES))
def test_model_example_prints_the_reference_lines(name):
    args = MODEL_EXAMPLES[name]
    want = run_example("examples", name, *args)
    got = run_example("examples_torch", name, *args)
    assert [masked(g) for g in got] == [masked(w) for w in want]
    if name == "train_e2e":
        assert got[-1] == ("PASS: crash/resume is bitwise identical to the "
                           "uninterrupted run")
