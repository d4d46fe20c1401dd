"""The port's search loops run their proxy training under deterministic
algorithms (``utils.helpers.deterministic``), so a search reproduces its
rewards from its seed on the card as the JAX package's does, with no
flag; the caller's settings come back after, and the CLI sets cuBLAS's
workspace before any work.

Each loop runs one round on the CPU with its proxy training stubbed: the
stub records the settings it runs under.
"""

import os

import numpy as np
import pytest
import torch

from segtpu_torch import main_search
from segtpu_torch import search as S
from segtpu_torch import supernet as sn
from segtpu_torch.config import SearchConfig
from segtpu_torch.data.datasets import SyntheticDataset
from segtpu_torch.parallel.fleet import run_fleet_search
from segtpu_torch.utils.helpers import CUBLAS_WORKSPACE, deterministic

K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs (the suite runs six
    workers on the machine's cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic)


def _run(loop, tmp_path, seen):
    """One round of ``loop`` on the CPU, its proxy training recording
    the settings it runs under into ``seen``."""
    cfg = SearchConfig(synthetic=True, num_classes=K, crop_size=(32, 32),
                       batch_size=(4, 4), num_epochs=(1, 0), num_iters=1,
                       agg_size=8, snapshot_dir=str(tmp_path), seed=5)
    data = SyntheticDataset(n=8, hw=(32, 32), num_classes=K, seed=5)
    if loop == "supernet":
        def stage1(pop, *a, **kw):
            seen.append(_settings())
            return pop, np.stack([np.eye(K, dtype=np.int64)] * pop.k), 1

        with pytest.MonkeyPatch.context() as m:
            m.setattr(sn, "_stage1", stage1)
            return sn.run_supernet_search(cfg, population=2, device="cpu",
                                          dataset=data)

    def proxy_train(*a, **kw):
        seen.append(_settings())
        return 0.5, 0.25

    with pytest.MonkeyPatch.context() as m:
        m.setattr(S, "proxy_train", proxy_train)
        if loop == "fleet":
            return run_fleet_search(cfg, devices=["cpu"] * 2, dataset=data)
        return S.run_search(cfg, dataset=data, device="cpu")


@pytest.mark.parametrize("caller", [(False, False, False),
                                    (True, True, False)])
@pytest.mark.parametrize("loop", ["search", "supernet", "fleet"])
def test_proxy_training_is_deterministic_and_settings_come_back(
        tmp_path, loop, caller):
    """Inside the loop the proxy training runs under deterministic
    algorithms (errors, not warnings, on an op without one) and cuDNN's
    deterministic convolutions; after it the caller's settings, whatever
    they were, are back."""
    saved = _settings()
    torch.use_deterministic_algorithms(caller[0], warn_only=caller[1])
    torch.backends.cudnn.deterministic = caller[2]
    seen = []
    try:
        saver = _run(loop, tmp_path, seen)
        after = _settings()
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
    assert seen and all(s == (True, False, True) for s in seen), seen
    assert after == caller
    assert len(saver.history) == len(seen) * (2 if loop == "supernet" else 1)


def test_deterministic_restores_after_an_error():
    saved = _settings()
    with pytest.raises(KeyError):
        with deterministic():
            assert _settings() == (True, False, True)
            raise KeyError("inside")
    assert _settings() == saved


def test_cli_sets_cublas_workspace_first(monkeypatch):
    """``main`` sets CUBLAS_WORKSPACE_CONFIG before it parses anything
    (so before any work on a card), and keeps a value the caller set."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(SystemExit):
        main_search.main(["--no-such-flag"])
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CUBLAS_WORKSPACE
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with pytest.raises(SystemExit):
        main_search.main(["--no-such-flag"])
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
