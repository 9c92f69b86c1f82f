"""Shared helpers of the layer parity tests (tests/test_torch_*.py): the
same numpy parameters and inputs through a JAX layer and its port, the
forward, the new state and the gradients of sum(y * g) with respect to
the parameters and the input (`jax.grad` against autograd). The JAX side
is jitted: one compile a case is cheaper than dispatching each op."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

F32 = dict(atol=1e-5, rtol=1e-4)


def perturbed(jlayer, input_type, seed=0, scale=0.1):
    """The reference layer's init, moved off its init constants, as numpy
    trees (params, state)."""
    p, s = jlayer.init(jax.random.PRNGKey(seed), input_type)
    rs = np.random.RandomState(seed + 1)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rs.randn(*a.shape).astype(a.dtype),
        p)
    return p, jax.tree_util.tree_map(np.asarray, s)


def to_torch(tree, grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(
            grad and np.issubdtype(np.asarray(a).dtype, np.floating)), tree)


def assert_tree_close(port, ref, tol=F32):
    pl, rl = jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        p = p.detach().numpy() if isinstance(p, torch.Tensor) else p
        np.testing.assert_allclose(p, np.asarray(r), **tol)


def check_layer(jl, pl, params, x, *, state=None, train=False, mask=None,
                tol=F32, grads=True, seed=5):
    """Forward (and new state) of both layers on the same inputs, then the
    gradients of sum(y * g) for a seeded g."""
    state = {} if state is None else state
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    jy, jst = jax.jit(lambda p, s_, xx: jl.apply(
        p, s_, xx, train=train, rng=None, mask=jmask))(jp, js, jnp.asarray(x))
    tp = to_torch(params, grad=grads)
    x_grad = grads and np.issubdtype(x.dtype, np.floating)
    tx = torch.from_numpy(np.array(x)).requires_grad_(x_grad)
    y, st = pl.apply(tp, to_torch(state), tx, train=train, mask=tmask)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **tol)
    assert_tree_close(st, jst, tol)
    if not grads:
        return y
    g = np.random.RandomState(seed).randn(*jy.shape).astype(jy.dtype)

    def f(p, xx):
        out, _ = jl.apply(p, js, xx, train=train, rng=None, mask=jmask)
        return (out * g).sum()

    argnums = (0, 1) if x_grad else (0,)
    jgrads = jax.jit(jax.grad(f, argnums=argnums))(jp, jnp.asarray(x))
    leaves = [t for t in jax.tree_util.tree_leaves(tp) if t.requires_grad]
    targets = leaves + ([tx] if x_grad else [])
    if not targets:
        return y
    tgrads = torch.autograd.grad((y * torch.from_numpy(g)).sum(), targets,
                                 allow_unused=True)
    ref = jax.tree_util.tree_leaves(jgrads[0]) + (
        [jgrads[1]] if x_grad else [])
    assert len(tgrads) == len(ref)
    for t, r in zip(tgrads, ref):
        t = torch.zeros(r.shape) if t is None else t
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **tol)
    return y
