"""Plain-JAX replacements: pytree dataclasses, the actor-critic MLP, and
the compile-cache path rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from spintorque_tpu import compile_cache, struct
from spintorque_tpu.envs.spin_torque import EnvState
from spintorque_tpu.physics import LLGSParams
from spintorque_tpu.rl.networks import ActorCritic


@struct.dataclass
class _Pair:
    a: object
    b: object
    extras: dict = struct.field(default_factory=dict)


def test_struct_dataclass_pytree_round_trip():
    x = _Pair(a=jnp.arange(3.0), b=(jnp.ones(2), 4.0), extras={"k": jnp.zeros(1)})
    leaves, tree = jax.tree.flatten(x)
    assert len(leaves) == 4
    y = jax.tree.unflatten(tree, leaves)
    assert isinstance(y, _Pair)
    doubled = jax.tree.map(lambda v: v * 2, x)
    np.testing.assert_array_equal(np.asarray(doubled.a), [0.0, 2.0, 4.0])
    # jit carries it through unchanged
    out = jax.jit(lambda p: p.replace(a=p.a + 1))(x)
    np.testing.assert_array_equal(np.asarray(out.a), [1.0, 2.0, 3.0])


def test_struct_dataclass_replace_frozen_and_default_factory():
    x = _Pair(a=1, b=2)
    y = x.replace(b=5)
    assert (x.b, y.b, y.a) == (2, 5, 1)
    with pytest.raises(dataclasses.FrozenInstanceError):
        x.a = 3
    # default_factory gives each instance its own dict
    assert x.extras == {} and x.extras is not _Pair(a=0, b=0).extras


def test_package_structs_are_pytrees():
    p = LLGSParams(1.0, 2.0, 3.0, 4.0, 5.0, jnp.zeros(3))
    assert len(jax.tree.leaves(p)) == 6
    assert p.replace(damping=7.0).damping == 7.0
    s = EnvState(*(jnp.zeros(2) for _ in range(8)))
    assert s.reward_stats == {}
    assert len(jax.tree.leaves(s)) == 8


@pytest.mark.parametrize("discrete,shared", [(False, False), (True, False), (False, True)])
def test_actor_critic_params_specs_and_outputs(discrete, shared):
    net = ActorCritic(action_dim=5 if discrete else 2, discrete=discrete,
                      hidden_sizes=(16, 8), shared_trunk=shared)
    obs = jnp.ones((4, 12), jnp.float32)
    params = net.init(jax.random.PRNGKey(0), obs)
    specs = net.partition_specs(params)
    assert jax.tree.structure(params) == jax.tree.structure(
        specs, is_leaf=lambda x: isinstance(x, P))
    trunks = ["shared"] if shared else ["actor", "critic"]
    for t in trunks:
        assert params[f"{t}_dense_0"]["kernel"].shape == (12, 16)
        assert params[f"{t}_dense_1"]["kernel"].shape == (16, 8)
        assert specs[f"{t}_dense_0"] == {"kernel": P(None, "model"), "bias": P("model")}
        assert specs[f"{t}_dense_1"] == {"kernel": P("model", None), "bias": P()}
    head = "actor_logits" if discrete else "actor_mean"
    assert params[head]["kernel"].shape == (8, net.action_dim)
    assert params["critic_value"]["kernel"].shape == (8, 1)
    assert ("log_std" in params) == (not discrete)
    for leaf in jax.tree.leaves(params):
        assert leaf.dtype == jnp.float32
    out = net.apply(params, obs)
    assert out[-1].shape == (4,)
    assert out[0].shape == (4, net.action_dim)


def test_actor_critic_initializers():
    """Orthogonal kernels at sqrt(2) / 0.01 / 1.0, zero biases and log_std."""
    net = ActorCritic(action_dim=2, hidden_sizes=(32, 32))
    params = net.init(jax.random.PRNGKey(1), jnp.ones((1, 32)))
    for name, scale in [("actor_dense_1", 2.0 ** 0.5), ("critic_dense_0", 2.0 ** 0.5),
                        ("actor_mean", 0.01), ("critic_value", 1.0)]:
        w = np.asarray(params[name]["kernel"], np.float64)
        gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        np.testing.assert_allclose(gram, scale ** 2 * np.eye(len(gram)), atol=1e-5)
        assert not np.any(np.asarray(params[name]["bias"]))
    assert not np.any(np.asarray(params["log_std"]))


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(compile_cache.DEFAULT_DIR)
        assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
        assert (compile_cache.DEFAULT_DIR.parent / "pyproject.toml").is_file()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
