"""The port's VariationalAutoencoder and MultiLayerNetwork.fit_pretrain
against the JAX package, on the CPU.

- The layer, with the same noise on both sides: the port takes ε as an
  argument, and for the reference's call the test replaces
  `jax.random.normal` with a function that hands out the same arrays in
  order (nothing in the JAX package changes). `encode`, `decode`,
  `apply`, `pretrain_score` (and its parameter gradients) and
  `reconstruction_probability`, gaussian and bernoulli, 1 and 3 samples,
  in f64 within 1e-10 (relative to each array's largest value).
- `fit_pretrain`: two deterministic AutoEncoders (corruption 0) from one
  zip match the reference within 1e-5 after 3 batches each, and the
  supervised head does not move. The VAE's pretrain score falls, only
  the VAE's parameters move, and `fit` then trains.
- The checkpoint: a VAE network's zip moves both ways, its nested
  parameters at the reference's key paths (``enc/0/W``) and its
  `updaterState.bin` byte for byte.
"""
import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import (
    AutoEncoder as JAE, OutputLayer as JOut,
    VariationalAutoencoder as JVAE,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam, Sgd as JSgd
from deeplearning4j_tpu.util.serialization import (
    load_model as jax_load, save_model as jax_save,
)
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    OutputLayer, VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, tree_leaves
from deeplearning4j_tpu_torch.util.params import iter_leaves
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, params_from_numpy, save_model,
)

N_IN, N_OUT, BATCH = 6, 3, 5


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _layers(dist, samples):
    kw = dict(n_out=N_OUT, encoder_layer_sizes=(8, 7),
              decoder_layer_sizes=(7,), reconstruction_distribution=dist,
              num_samples=samples, pzx_activation="tanh")
    return JVAE(**kw), VariationalAutoencoder(**kw)


def _params(jl, seed=0):
    """The reference's init in f64, moved off its zero biases, as numpy
    (its MLPs as lists) and as the port's tree (dicts by index)."""
    p, _ = jl.init(jax.random.PRNGKey(seed), JIT.feed_forward(N_IN),
                   jnp.float64)
    rs = np.random.RandomState(seed + 1)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape), p)
    return p, params_from_numpy(p, "cpu")


def _data(dist, seed=2):
    rs = np.random.RandomState(seed)
    if dist == "bernoulli":
        return (rs.rand(BATCH, N_IN) > 0.5).astype("float64")
    return rs.randn(BATCH, N_IN)


def _eps(n, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(BATCH, N_OUT) for _ in range(n)]


def _fixed_normal(monkeypatch, eps):
    """jax.random.normal handing out `eps` in order, once round."""
    draws = iter(eps)

    def normal(key, shape=(), dtype=jnp.float64):
        e = next(draws)
        assert tuple(shape) == e.shape
        return jnp.asarray(e, dtype)
    monkeypatch.setattr(jax.random, "normal", normal)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_encode_decode_apply_match(x64):
    jl, pl = _layers("gaussian", 1)
    jp, pp = _params(jl)
    x = _data("gaussian")
    jmu, jlv = jl.encode(jp, jnp.asarray(x))
    pmu, plv = pl.encode(pp, torch.from_numpy(x))
    assert _rel(pmu, jmu) <= 1e-10 and _rel(plv, jlv) <= 1e-10
    z = np.random.RandomState(4).randn(BATCH, N_OUT)
    assert _rel(pl.decode(pp, torch.from_numpy(z)),
                jl.decode(jp, jnp.asarray(z))) <= 1e-10
    assert _rel(pl.apply(pp, {}, torch.from_numpy(x))[0], jmu) <= 1e-10
    assert pl.output_type(InputType.feed_forward(N_IN)) == \
        InputType.feed_forward(N_OUT)


@pytest.mark.parametrize("samples", [1, 3])
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_pretrain_score_and_gradients_match(x64, monkeypatch, dist, samples):
    jl, pl = _layers(dist, samples)
    jp, pp = _params(jl)
    x = _data(dist)
    eps = _eps(samples)
    _fixed_normal(monkeypatch, eps + eps)      # value, then the gradient
    jscore = jl.pretrain_score(jp, jnp.asarray(x), jax.random.PRNGKey(0))
    jgrad = jax.grad(lambda p: jl.pretrain_score(
        p, jnp.asarray(x), jax.random.PRNGKey(0)))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    live = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                  pp)
    pscore = pl.pretrain_score(live, torch.from_numpy(x),
                               eps=[torch.from_numpy(e) for e in eps])
    assert abs(float(pscore.detach()) - float(jscore)) \
        <= 1e-10 * abs(float(jscore))
    pgrad = torch.autograd.grad(pscore, tree_leaves(live))
    ref = jax.tree_util.tree_leaves(jgrad)
    assert len(pgrad) == len(ref)
    for g, r in zip(pgrad, ref):
        assert _rel(g, r) <= 1e-10


@pytest.mark.parametrize("samples", [1, 3])
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_reconstruction_probability_matches(x64, monkeypatch, dist,
                                            samples):
    jl, pl = _layers(dist, 1)
    jp, pp = _params(jl, seed=5)
    x = _data(dist, seed=6)
    eps = _eps(samples, seed=7)
    _fixed_normal(monkeypatch, eps)
    ref = jl.reconstruction_probability(jp, jnp.asarray(x),
                                        jax.random.PRNGKey(1), samples)
    got = pl.reconstruction_probability(pp, torch.from_numpy(x),
                                        num_samples=samples, eps=eps)
    assert got.shape == (BATCH,)
    assert _rel(got, ref) <= 1e-10


def test_noise_comes_from_the_generator():
    _, pl = _layers("gaussian", 2)
    p, _ = pl.init(torch.Generator().manual_seed(0),
                   InputType.feed_forward(N_IN))
    x = torch.from_numpy(_data("gaussian")).float()
    a = pl.pretrain_score(p, x, torch.Generator().manual_seed(1))
    b = pl.pretrain_score(p, x, torch.Generator().manual_seed(1))
    c = pl.pretrain_score(p, x, torch.Generator().manual_seed(2))
    assert float(a) == float(b) != float(c)
    with pytest.raises(ValueError, match="generator"):
        pl.pretrain_score(p, x)
    assert sorted(p) == ["dec", "enc", "muW", "mub", "outW", "outb"]
    assert sorted(p["enc"]) == ["0", "1"] and p["outW"].shape == (7, 12)


# ------------------------------------------------------------ fit_pretrain
def _structured(n, f=12, c=3, seed=7):
    rs = np.random.RandomState(seed)
    protos = rs.randn(c, f) * 2.0
    ys = rs.randint(0, c, n)
    X = protos[ys] + 1.6 * rs.randn(n, f)
    return X.astype("float32"), np.eye(c, dtype="float32")[ys]


def test_autoencoder_pretraining_matches_the_reference(tmp_path):
    conf = (JNNC.Builder().seed(0).updater(JAdam(5e-3)).list()
            .layer(JAE(n_out=8, activation="sigmoid", corruption_level=0.0))
            .layer(JAE(n_out=6, activation="sigmoid", corruption_level=0.0,
                       updater=JSgd(0.5)))
            .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(12)).build())
    jnet = JMLN(conf).init()
    path = str(tmp_path / "ae.zip")
    jax_save(jnet, path)
    pnet = load_model(path, device="cpu")
    head = pnet.params["2"]["W"].clone()
    X, Y = _structured(3 * 16)
    jnet.fit_pretrain((X, Y), epochs=1, batch_size=16)
    pnet.fit_pretrain((X, Y), epochs=1, batch_size=16)
    for path_, leaf in iter_leaves(pnet.params):
        ref = jnet.params
        for k in path_:
            ref = ref[k]
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0, err_msg="/".join(path_))
    assert torch.equal(pnet.params["2"]["W"], head)
    np.testing.assert_allclose(pnet.score(), jnet.score(), rtol=1e-5)
    counts = [int(t) for p_, t in iter_leaves(pnet.opt_state)
              if p_[-1] == "count"]
    assert counts and not any(counts)                  # a fresh state


def _vae_conf(seed=1, builder=NeuralNetConfiguration, adam=Adam,
              vae=VariationalAutoencoder, out=OutputLayer,
              input_type=InputType):
    return (builder.Builder().seed(seed).updater(adam(3e-3)).list()
            .layer(vae(n_out=4, encoder_layer_sizes=(10,),
                       decoder_layer_sizes=(10,)))
            .layer(out(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(input_type.feed_forward(12)).build())


def test_vae_pretrain_score_falls_and_only_the_vae_moves():
    X, Y = _structured(240)
    net = MultiLayerNetwork(_vae_conf(), device="cpu").init()
    head = {k: t.clone() for k, t in net.params["1"].items()}
    vae_before = [t.clone() for t in tree_leaves(net.params["0"])]
    net.fit_pretrain((X, Y), epochs=3, batch_size=48)
    s1 = net.score()
    net.fit_pretrain((X, Y), epochs=6, batch_size=48)
    assert net.score() < s1
    assert all(torch.equal(net.params["1"][k], v) for k, v in head.items())
    assert all((a - b).abs().max() > 1e-3
               for a, b in zip(tree_leaves(net.params["0"]), vae_before))
    net.fit((X, Y), epochs=3, batch_size=48)
    assert np.isfinite(net.score())


def _updater_bytes(path):
    with zipfile.ZipFile(path) as zf:
        return zf.read("updaterState.bin"), zf.read("coefficients.npz")


def test_vae_zip_moves_both_ways_byte_for_byte(tmp_path):
    X, Y = _structured(16, seed=9)
    jnet = JMLN(_vae_conf(builder=JNNC, adam=JAdam, vae=JVAE, out=JOut,
                          input_type=JIT)).init()
    jnet.fit((X, Y), batch_size=8, scan_steps=1, prefetch=False)
    jpath, ppath = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jax_save(jnet, jpath)
    pnet = load_model(jpath, device="cpu")
    assert sorted(pnet.params["0"]["enc"]) == ["0"]
    assert int(pnet.opt_state["0"]["count"]) == 2
    save_model(pnet, ppath)
    j_state, j_coef = _updater_bytes(jpath)
    p_state, p_coef = _updater_bytes(ppath)
    assert p_state == j_state
    with np.load(io.BytesIO(j_coef)) as a, np.load(io.BytesIO(p_coef)) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "0/enc/0/W" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # one more step on each side, then the port's zip back in the reference
    pnet.fit((X, Y), batch_size=8)
    jnet.fit((X, Y), batch_size=8, scan_steps=1, prefetch=False)
    save_model(pnet, ppath)
    back = jax_load(ppath)
    assert isinstance(back.params["0"]["enc"], list)
    for a, b in zip(jax.tree_util.tree_leaves(back.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    jax_save(back, jpath)
    assert _updater_bytes(jpath)[0] == _updater_bytes(ppath)[0]
