"""pytest settings of the benchmark's own tests: the `cuda` marker, and
the fixtures that shrink a cell to a size the CPU holds."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch

    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
    # Workers share the machine's cores: two threads each.
    torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def scenes(tmp_path_factory):
    """A scene directory shared by the tests of one pytest run."""
    return str(tmp_path_factory.mktemp("scenes"))


def small(name, width=16, height=16, pixels=32, **scene):
    """Cell `name`'s workload at `width` x `height` with `pixels`
    compared (render cells), and `scene`'s settings on top."""
    from rgkbench import harness

    wl = copy.deepcopy(harness.workload(name))
    wl["scene"].update({"output-width": width, "output-height": height},
                       **scene)
    if "pixels" in wl["check"]:
        wl["check"]["pixels"] = pixels
    return wl


def small_config(name, **changes):
    from rgkbench import harness

    cfg = copy.deepcopy(harness.config(name))
    cfg.update(changes)
    return cfg
