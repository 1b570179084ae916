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


# ---------------------------------------------------------------------------
# the checksum half and the dtype boundary of a train-state snapshot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", [b"", b"swap", bytes(range(256)) * 17])
def test_checksum_bytes_equals_jax(data):
    assert tio.checksum_bytes(data) == jio.checksum_bytes(data)
    assert tio.checksum_bytes(data).startswith("crc32:")


def test_flipped_byte_raises_checksum_error(tmp_path):
    tree = tio.params_from_numpy(_mixed_tree())
    path = str(tmp_path / "t.ckpt")
    tio.save_pytree(path, tree)
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    good = tio.checksum_bytes(bytes(raw))
    assert tio.pack_pytree(tio.load_pytree(path, tree,
                                           expected_checksum=good)) == raw
    raw[len(raw) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(tio.ChecksumError, match="corrupt"):
        tio.load_pytree(path, tree, expected_checksum=good)
    assert isinstance(tio.ChecksumError("x"), ValueError)


def test_payload_intact_catches_truncation():
    raw = tio.pack_pytree(tio.params_from_numpy(_mixed_tree()))
    assert tio.payload_intact(raw) and jio.payload_intact(raw)
    assert not tio.payload_intact(raw[:-7])
    assert tio.payload_intact(raw[:-7]) == jio.payload_intact(raw[:-7])


def test_optional_prefixes_keep_the_template_leaf(tmp_path):
    tree = tio.params_from_numpy(_mixed_tree())
    path = str(tmp_path / "t.ckpt")
    tio.save_pytree(path, tree)
    extra = torch.full((2,), 7.0)
    template = dict(tree, scale={"s": extra})
    back = tio.load_pytree(path, template, optional_prefixes=("scale/",))
    assert back["scale"]["s"] is extra
    assert torch.equal(back["w"], tree["w"])
    with pytest.raises(KeyError, match="scale/s"):
        tio.load_pytree(path, template)


def test_train_state_dtype_boundary(tmp_path):
    """On disk: ``step`` int32, ``rng`` uint32, the loss-scale state under
    JAX's ``scale/.field`` keys; restored in the port's int64."""
    import msgpack
    from repro_torch.checkpoint.state import load_train_state, save_train_state
    from repro_torch.train.loop import init_train_state, stack_train_state
    bundle = {"params": {"w": torch.ones(2, 3)}, "state": {}}
    opt = {"mu": {"w": torch.zeros(2, 3)}}
    for state, lead in ((init_train_state(bundle, opt, step=5, seed=3), []),
                        (stack_train_state(
                            {"params": {"w": torch.ones(4, 2, 3)},
                             "state": {}}, {"mu": {"w": torch.zeros(4, 2, 3)}},
                            4, seed=3), [4])):
        path = str(tmp_path / f"s{len(lead)}.msgpack")
        save_train_state(path, state)
        with open(path, "rb") as f:
            payload = msgpack.unpackb(f.read(), raw=False)
        assert (payload["step"]["dtype"], payload["step"]["shape"]) == \
            ("int32", lead)
        assert (payload["rng"]["dtype"], payload["rng"]["shape"]) == \
            ("uint32", lead + [2])
        assert [k for k in payload if k.startswith("scale/")] == [
            "scale/.scale", "scale/.growth_count", "scale/.skipped"]
        back = load_train_state(path, state)
        assert back.step.dtype == back.rng.dtype == torch.int64
        assert torch.equal(back.rng, state.rng)
        assert torch.equal(back.step, state.step)


def test_load_takes_the_template_dtype_where_exact(tmp_path):
    path = str(tmp_path / "t.ckpt")
    tio.save_pytree(path, {"i": torch.tensor([1, -2], dtype=torch.int32),
                           "f": torch.tensor([0.5, 3.0]),
                           "big": torch.tensor([2 ** 40]),
                           "x": torch.tensor([0.1])})
    got = tio.load_pytree(path, {"i": torch.zeros(2, dtype=torch.int64),
                                 "f": torch.zeros(2, dtype=torch.bfloat16),
                                 "big": torch.zeros(1, dtype=torch.int64),
                                 "x": torch.zeros(1, dtype=torch.float64)})
    assert got["i"].dtype == torch.int64 and got["i"].tolist() == [1, -2]
    assert got["f"].dtype == torch.bfloat16 and got["f"].tolist() == [0.5, 3.0]
    assert got["x"].dtype == torch.float64
    with pytest.raises(ValueError, match="'big'.*exactly"):
        tio.load_pytree(path, {"big": torch.zeros(1, dtype=torch.int32)})
    with pytest.raises(ValueError, match="'x'.*exactly"):
        tio.load_pytree(path, {"x": torch.zeros(1, dtype=torch.bfloat16)})
