"""The port's examples (``nsdp_tpu_torch/examples``, the counterparts of
``examples/quickstart.py`` and ``examples/serve_interactive.py``) run end to
end on the CPU."""

import os

import pytest
import torch

from nsdp_tpu_torch.examples import quickstart, serve_interactive


@pytest.fixture(autouse=True)
def _torch_settings():
    """The entry points set torch's CPU threads and float32 matmul
    precision for the process; put them back for the tests that follow."""
    threads, precision = torch.get_num_threads(), torch.get_float32_matmul_precision()
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def test_quickstart_trains_evaluates_and_writes_meshes(tmp_path):
    mesh_dir = quickstart.main(["--workdir", str(tmp_path), "--epochs", "2",
                                "--device", "cpu"])
    names = sorted(os.listdir(mesh_dir))
    assert names and all(n.endswith(".ply") for n in names)


def test_serve_interactive_session_equals_the_full_evaluation(tmp_path):
    gap = serve_interactive.main(["--workdir", str(tmp_path), "--n_drags", "2",
                                  "--device", "cpu"])
    assert gap == 0.0
