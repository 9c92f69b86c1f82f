"""The port's ZeRO helpers (`parallel/zero.py`) against the reference's.

`zero_spec`, `sharded_fraction` and the stage validation give the
reference's answers; ZeRO-1 and ZeRO-3 over a two-rank gloo group
(`tests/_torch_dist`) train a ComputationGraph and a max-norm-constrained
network within 1e-5 relative of the reference's ZeRO fits after 3 steps,
every rank equal; `zero_place` hands each rank its dim-0 piece.
"""
import numpy as np
import pytest
import torch

from _torch_dist import (
    RankPool, assert_params_close, blobs, ref_flat, ref_graph, ref_mesh,
    ref_mlp, ref_source, save_ref,
)
from deeplearning4j_tpu.parallel import (
    ParallelWrapper as JWrapper, sharded_fraction as jfraction,
)
from deeplearning4j_tpu.parallel.zero import zero_spec as jzero_spec
from deeplearning4j_tpu.util.serialization import load_model as jload
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, sharded_fraction, zero_place, zero_spec,
)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


@pytest.mark.parametrize("shape,n", [((8, 16), 2), ((6, 16), 4),
                                      ((3,), 2), ((), 2), ((16,), 1),
                                      ((4, 4, 3, 8), 8)])
def test_zero_spec_is_the_references(shape, n):
    leaf = np.zeros(shape, np.float32)
    assert tuple(zero_spec(torch.from_numpy(leaf), n)) == \
        tuple(jzero_spec(leaf, n))


def test_sharded_fraction_and_zero_place():
    import jax.numpy as jnp
    tree = {"W": np.ones((8, 16), np.float32), "b": np.ones((3,), np.float32)}
    ours = {k: torch.from_numpy(v) for k, v in tree.items()}
    theirs = {k: jnp.asarray(v) for k, v in tree.items()}
    # a one-rank mesh (no process group): nothing splits
    one = Mesh(1, 1)
    assert sharded_fraction(ours, one) == jfraction(theirs, ref_mesh(1))
    two = Mesh(1, 1)
    two.shape = {"data": 2, "model": 1}
    assert sharded_fraction(ours, two) == jfraction(theirs, ref_mesh(2))
    placed = zero_place(ours, two)
    assert placed["W"].shape == (4, 16) and placed["b"].shape == (3,)


def test_zero_stage_validation_raises_the_references_error():
    from deeplearning4j_tpu_torch.util.serialization import load_model
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = save_ref(ref_mlp(), f"{d}/m.zip")
        jnet, net = jload(path), load_model(path, device="cpu")
    with pytest.raises(ValueError) as theirs:
        JWrapper(jnet, zero_stage=2)
    with pytest.raises(ValueError) as ours:
        ParallelWrapper(net, zero_stage=2)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="requires SYNC_GRADIENTS"):
        ParallelWrapper(net, mode="averaging", zero_stage=1)


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_graph_parity(pool, tmp_path, stage):
    path = save_ref(ref_graph(), tmp_path / "g.zip", graph=True)
    X, Y = blobs()
    ref = jload(path)
    JWrapper(ref, mesh=ref_mesh(2), zero_stage=stage).fit(
        ref_source(ref, X, Y, 32), epochs=1)
    out = pool.run("wrapper_fit", 2, zip_path=path, X=X, Y=Y, batch=32,
                   zero_stage=stage)
    np.testing.assert_array_equal(out[0]["flat"], out[1]["flat"])
    assert_params_close(out[0]["flat"], ref_flat(ref))


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_constraints_parity(pool, tmp_path, stage):
    """The max-norm projection after the sharded update (on the whole
    parameter, then the rank's piece), as the reference projects."""
    path = save_ref(ref_mlp(constraint=True), tmp_path / "c.zip")
    X, Y = blobs()
    ref = jload(path)
    JWrapper(ref, mesh=ref_mesh(2), zero_stage=stage).fit(
        ref_source(ref, X, Y, 32), epochs=1)
    out = pool.run("wrapper_fit", 2, zip_path=path, X=X, Y=Y, batch=32,
                   zero_stage=stage)
    np.testing.assert_array_equal(out[0]["flat"], out[1]["flat"])
    assert_params_close(out[0]["flat"], ref_flat(ref))
