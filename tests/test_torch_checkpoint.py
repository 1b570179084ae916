"""The weight bridge: the port's msgpack checkpoints against the JAX package's.

The same tree must pack to the same bytes in both packages, round-trip
JAX -> torch -> JAX exactly, and a checkpoint written by JAX must load
through the port's ``--ckpt``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402


def _jax_params(arch="internlm2-1.8b", seed=0):
    jm = JModel(jreg.get_smoke_config(arch))
    return jax.device_get(jm.init(jax.random.PRNGKey(seed)))


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "b16": rng.standard_normal((5,)).astype(np.float32),
        "nested": {"z": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "a": [np.ones((2,), np.float32), np.int8(-3)]},
        "step": np.int64(7),
    }


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-1b"])
def test_pack_is_byte_identical_to_jax(arch):
    jp = _jax_params(arch)
    assert tio.pack_pytree(tio.params_from_numpy(jp)) == jio.pack_pytree(jp)


def test_pack_mixed_tree_with_bf16_is_byte_identical():
    tree = _mixed_tree()
    jtree = dict(tree, b16=jnp.asarray(tree["b16"], jnp.bfloat16))
    ttree = tio.params_from_numpy(jax.device_get(jtree))
    assert ttree["b16"].dtype == torch.bfloat16
    assert tio.pack_pytree(ttree) == jio.pack_pytree(jtree)


def test_roundtrip_jax_torch_jax(tmp_path):
    jp = _jax_params()
    tp = tio.params_from_numpy(jp)
    back = tio.params_to_numpy(tp)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    # written by the port, read by JAX
    path = str(tmp_path / "port.ckpt")
    tio.save_pytree(path, tp)
    restored = jio.load_pytree(path, jp)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        jp, restored)


def test_jax_checkpoint_loads_through_ckpt_flag(tmp_path, capsys):
    jp = _jax_params(seed=5)
    path = str(tmp_path / "jax.ckpt")
    jio.save_pytree(path, jp)
    tm = TModel(treg.get_smoke_config("internlm2-1.8b"))
    template = tm.init(torch.Generator().manual_seed(0))
    loaded = tio.load_pytree(path, template)
    for key, leaf in tio._items(loaded):
        assert leaf.dtype == torch.float32
    assert tio.pack_pytree(loaded) == jio.pack_pytree(jp)

    out, _ = tserve.main(["--device", "cpu", "--ckpt", path, "--batch", "2",
                          "--prompt-len", "8", "--new-tokens", "3", "--seed",
                          "1"])
    assert "restored" in capsys.readouterr().out
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, tm.cfg.vocab_size, (2, 8), generator=g)
    want, _ = tserve.generate(tm, tio.params_from_numpy(jp), prompts, 3,
                              engine="compiled")
    assert torch.equal(out, want)


def test_load_rejects_missing_leaf_and_shape(tmp_path):
    tree = tio.params_from_numpy(_mixed_tree())
    path = str(tmp_path / "t.ckpt")
    tio.save_pytree(path, tree)
    with pytest.raises(KeyError, match="extra"):
        tio.load_pytree(path, dict(tree, extra=torch.zeros(1)))
    with pytest.raises(ValueError, match="shape"):
        tio.load_pytree(path, dict(tree, w=torch.zeros(4, 3)))
    back = tio.load_pytree(path, tree)
    assert tio.pack_pytree(back) == tio.pack_pytree(tree)
