"""``parallel.hosts``: process groups and the scan x map mesh, on gloo
ranks spawned on the CPU."""

import logging
import socket

import numpy as np
import pytest
import torch.distributed as dist

from torch_port_util import load_ranks, mesh_worker, spawn_ranks, \
    torchrun_worker

from sfm_tpu_torch.parallel import initialize_hosts, rank_device


def test_no_cluster_warns_and_stays_single_process(monkeypatch, caplog):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    with caplog.at_level(logging.WARNING):
        initialize_hosts(device="cpu")
    assert not dist.is_initialized()
    assert "single-process" in caplog.text


def test_a_cluster_that_cannot_work_raises():
    # a rank outside the world fails before any rendezvous
    with pytest.raises(RuntimeError, match="not a rank of 2"):
        initialize_hosts("127.0.0.1:1", 2, 5, device="cpu")
    with pytest.raises(RuntimeError, match="all needed"):
        initialize_hosts("127.0.0.1:1", 2, device="cpu")
    assert not dist.is_initialized()


def test_the_card_by_default_raises_without_one(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_hosts()
    assert not dist.is_initialized()


def _cards(monkeypatch, n):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_rank_device_takes_the_hosts_cards_in_rank_order(monkeypatch):
    """torchrun's LOCAL_RANK picks the card; without it (a cluster given
    explicitly) the rank in the world does, modulo the host's cards."""
    import torch
    _cards(monkeypatch, 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert rank_device() == torch.device("cuda", 0)
    assert [rank_device("cuda", r).index for r in range(8)] \
        == [0, 1, 2, 3, 0, 1, 2, 3]
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert rank_device("cuda", 6) == torch.device("cuda", 3)
    assert rank_device("cpu", 6) == torch.device("cpu")


def test_an_explicit_cluster_sets_its_card_from_process_id(monkeypatch):
    """``initialize_hosts(coordinator, 8, 6)`` on a host of 4 cards, with
    no LOCAL_RANK, makes card 2 current before it joins under NCCL."""
    import torch
    _cards(monkeypatch, 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    seen = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.append(("device", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    initialize_hosts("127.0.0.1:1", 8, 6)
    assert seen == [("device", torch.device("cuda", 2)),
                    ("nccl", dict(init_method="tcp://127.0.0.1:1",
                                  world_size=8, rank=6))]


def test_torchrun_variables_initialise_gloo(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spawn_ranks(torchrun_worker, 2, (tmp_path, port), tmp_path, init=False)
    for r, out in enumerate(load_ranks(tmp_path, "torchrun", 2)):
        assert int(out["world"]) == 2 and int(out["rank"]) == r
        assert str(out["backend"]) == "gloo"
        assert float(out["total"]) == 3.0


def test_scan_map_mesh_on_eight_ranks(tmp_path):
    """LOCAL_WORLD_SIZE=4 on 8 ranks: two hosts, so (2, 4); n_scan=3 steps
    down to 2.  Rank r sits at (r // 4, r % 4)."""
    spawn_ranks(mesh_worker, 8, (tmp_path, 4), tmp_path)
    for r, out in enumerate(load_ranks(tmp_path, "mesh", 8)):
        assert tuple(out["shape"]) == (2, 4)
        assert tuple(out["three"]) == (2, 4)
        assert list(out["names"]) == ["scan", "map"]
        assert tuple(out["pos"]) == (r // 4, r % 4)
        # scan group: ranks {r % 4, r % 4 + 4}; map group: the 4 of a host
        np.testing.assert_array_equal(
            out["sums"], [2 * (r % 4) + 4, sum(range(4 * (r // 4),
                                                     4 * (r // 4) + 4))])
