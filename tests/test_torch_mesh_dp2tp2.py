"""The port's sharded steps on a live mesh of (2, 2) over ("data",
"model"), with ``moe_a2a``: gloo ranks on the CPU against the JAX package's
steps under the same rules.  ``_torch_mesh_parity.py`` runs the layout
once; each check below is one of its results."""

import pytest

import _torch_mesh_parity as mp

LAYOUT = "dp2tp2"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mp.run_layout(LAYOUT, str(tmp_path_factory.mktemp(LAYOUT)))


@pytest.mark.parametrize("check", mp.checks(LAYOUT))
def test_mesh_check(results, check):
    passed, detail = results[check]
    assert passed, f"{check}: {detail}"
