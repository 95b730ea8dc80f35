"""The port's dry run on the (2, 2, 2) ("pod", "data", "model") fake mesh:
train, prefill and decode of the reduced config of every family give the
reference's record (``tests/test_torch_dryrun.py`` holds the (2, 2) mesh;
the two files are apart so that each stays under 90 s in one process: a
three-dimensional mesh makes DTensor's first sharding propagation of each
operator several times slower).
"""
import pytest

from test_torch_dryrun import FAMILY_REPS, check_run_cell


@pytest.mark.parametrize("name", FAMILY_REPS)
def test_run_cell_gives_the_reference_record_on_pods(name, tmp_path, monkeypatch):
    check_run_cell(name, (2, 2, 2), tmp_path, monkeypatch)
