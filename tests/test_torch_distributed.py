"""The port's process-group runtime and mesh (`parallel/distributed.py`,
`parallel/mesh.py`).

`DistributedConfig.from_env` reads the reference's variables and
torchrun's; `initialize_distributed` forms a group or raises (never the
reference's "continuing single-process" warning); over a 4-rank gloo
group (`tests/_torch_dist`) the mesh places ranks row-major over (data,
stage, seq, model), as the reference's `reshape(d, p, s, m)`, with a
group for each axis and for (data, seq) and (data, stage), and the
plan's collectives run.
"""
import numpy as np
import pytest
import torch.distributed as dist

from _torch_dist import RankPool
from deeplearning4j_tpu.parallel import distributed as jdist
from deeplearning4j_tpu_torch.parallel import (
    DistributedConfig, MeshConfig, build_mesh, data_sharding,
    initialize_distributed, replicated_sharding,
)
from deeplearning4j_tpu_torch.parallel import distributed as pdist
from deeplearning4j_tpu_torch.parallel.mesh import P

ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
       "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_from_env_reads_the_references_variables(clean_env):
    clean_env.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    clean_env.setenv("NUM_PROCESSES", "4")
    clean_env.setenv("PROCESS_ID", "2")
    ours, theirs = DistributedConfig.from_env(), \
        jdist.DistributedConfig.from_env()
    assert (ours.coordinator_address, ours.num_processes,
            ours.process_id) == (theirs.coordinator_address,
                                 theirs.num_processes, theirs.process_id)
    assert ours.configured and ours.local_rank is None


def test_from_env_reads_torchruns_variables(clean_env):
    for k, v in (("MASTER_ADDR", "host"), ("MASTER_PORT", "29500"),
                 ("WORLD_SIZE", "8"), ("RANK", "5"), ("LOCAL_RANK", "1")):
        clean_env.setenv(k, v)
    cfg = DistributedConfig.from_env()
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            cfg.local_rank) == ("host:29500", 8, 5, 1)
    assert str(pdist.rank_device("cuda", cfg)) == "cuda:1"
    assert str(pdist.rank_device("cpu", cfg)) == "cpu"


def test_initialize_without_a_group_and_failures_raise(clean_env):
    assert not dist.is_initialized()
    assert initialize_distributed(device_type="cpu") is False
    assert not dist.is_initialized()
    assert (pdist.process_index(), pdist.process_count(),
            pdist.is_coordinator()) == (0, 1, True)
    with pytest.raises(RuntimeError, match="world size"):
        initialize_distributed(DistributedConfig(
            coordinator_address="127.0.0.1:1"), device_type="cpu")
    # an address nobody serves: the init fails loudly
    with pytest.raises(Exception):
        initialize_distributed(DistributedConfig(
            coordinator_address=f"127.0.0.1:{pdist.free_port()}",
            num_processes=2, process_id=1, initialization_timeout_s=2),
            device_type="cpu")
    assert not dist.is_initialized()


def test_one_rank_group_and_its_mesh(clean_env):
    try:
        assert initialize_distributed(device_type="cpu",
                                      single=True) is False
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        mesh = build_mesh()
        assert mesh.shape == {"data": 1, "stage": 1, "seq": 1, "model": 1}
        assert data_sharding(mesh).spec == P("data")
        assert replicated_sharding(mesh).spec == P()
        assert str(P(None, "model")) == "PartitionSpec(None, 'model')"
        assert str(P("data")) == "PartitionSpec('data',)"
        # seq and stage resolve as the reference's: a degree the world
        # does not hold raises its error
        with pytest.raises(ValueError, match="!= available devices 1"):
            build_mesh(MeshConfig(data=2, seq=2))
        with pytest.raises(ValueError, match="one device per rank"):
            build_mesh(devices=["cpu", "cpu"])
    finally:
        pdist.shutdown_distributed()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def test_mesh_over_four_ranks_is_row_major(pool):
    out = pool.run("mesh_coords", 4, data=2, model=2)
    assert [o["coords"] for o in out] == [[0, 0], [0, 1], [1, 0], [1, 1]] \
        or [tuple(o["coords"]) for o in out] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    assert [o["data_group"] for o in out] == [[0, 2], [1, 3], [0, 2],
                                              [1, 3]]
    assert [o["model_group"] for o in out] == [[0, 1], [0, 1], [2, 3],
                                               [2, 3]]
    assert [o["coordinator"] for o in out] == [True, False, False, False]
    assert [o["index"] for o in out] == [0, 1, 2, 3]
    assert all(o["count"] == 4 and o["shape"] == {
        "data": 2, "stage": 1, "seq": 1, "model": 2} for o in out)


def test_the_collectives_run_over_gloo(pool):
    out = pool.run("gloo_ops", 2)
    for summed, gathered in out:
        np.testing.assert_array_equal(summed, [1, 1, 1])
        np.testing.assert_array_equal(gathered, [0, 0, 0, 1, 1, 1])


MESHES4 = [("data2_seq2", dict(data=2, seq=2), {
    "coords": [[0, 0, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0], [1, 0, 1, 0]],
    "data": [[0, 2], [1, 3], [0, 2], [1, 3]],
    "seq": [[0, 1], [0, 1], [2, 3], [2, 3]],
    "stage": [[0], [1], [2], [3]]}),
    ("data2_stage2", dict(data=2, stage=2), {
        "coords": [[0, 0, 0, 0], [0, 1, 0, 0], [1, 0, 0, 0], [1, 1, 0, 0]],
        "data": [[0, 2], [1, 3], [0, 2], [1, 3]],
        "stage": [[0, 1], [0, 1], [2, 3], [2, 3]],
        "seq": [[0], [1], [2], [3]]})]


@pytest.mark.parametrize("name,kw,want", MESHES4, ids=[m[0] for m in MESHES4])
def test_mesh_with_seq_and_stage_axes(pool, name, kw, want):
    """data=2,seq=2 and data=2,stage=2 over four ranks: the reference's
    (data, stage, seq, model) coordinates, a group per axis, and the
    two-axis groups the context and pipeline trainers reduce over."""
    import jax

    from deeplearning4j_tpu.parallel import MeshConfig as JConfig
    from deeplearning4j_tpu.parallel import build_mesh as jbuild
    ref = jbuild(JConfig(**kw), devices=jax.devices()[:4])
    out = pool.run("mesh_coords4", 4, **kw)
    assert [o["coords"] for o in out] == want["coords"]
    for axis in ("data", "seq", "stage"):
        assert [o["groups"][axis] for o in out] == want[axis]
    assert [o["groups"]["model"] for o in out] == [[r] for r in range(4)]
    split = "seq" if kw.get("seq") else "stage"
    other = "stage" if split == "seq" else "seq"
    assert all(o["groups"]["data+" + split] == [0, 1, 2, 3]
               and o["groups"]["data+" + other] == o["groups"]["data"]
               for o in out)
    assert all(o["shape"] == dict(ref.shape) for o in out)
    assert list(out[0]["shape"]) == list(ref.shape)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for r, o in enumerate(out):
        assert tuple(np.argwhere(ids == r)[0]) == tuple(o["coords"])
