"""The control, at a size a test run holds: the reference with its products
in float8 e4m3, the precision below the configuration's bfloat16, reads
further from the float32 reference than the program does, on each cell's
numbers."""

import pytest

from bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("control"))


def test_the_training_control_reads_beyond_the_program(root):
    r = tiny.run(root, tiny.TRAIN, control=True)
    program = {k: v["value"] for k, v in r["checks"].items()}
    control = r["notes"]["control"]
    assert control["grad_norm_gap"] > 3 * program["grad_norm_gap"]
    assert control["loss_gap"] > 3 * program["loss_gap"]
    assert any(control[k] > tiny.LIMITS[tiny.TRAIN][k] for k in control)


def test_the_serving_control_reads_beyond_the_program(root):
    runs = [tiny.run(root, tiny.SERVE, control=True, seed=s, seconds=2.0)
            for s in (3, 4, 6)]
    program = sorted(r["checks"]["logit_gap_mean"]["value"] for r in runs)
    control = sorted(r["notes"]["control"]["logit_gap_mean"] for r in runs)
    assert control[1] > 3 * program[1], (program, control)
    assert control[-1] > tiny.LIMITS[tiny.SERVE]["logit_gap_mean"], control
