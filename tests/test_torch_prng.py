"""The port's threefry twin, Markov-LM data and Loader against JAX's.

Integer outputs (keys, fold_in, split, bits, randint, permutation) and
``uniform`` must be bitwise equal to ``jax.random``; ``normal`` passes
through erfinv and log1p of another library and is held to 4 ulp. The
Markov-LM tokens (an argmax over gumbel noise plus normal logits) and every
Loader batch, aug_seed and shard must be equal.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402

from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_markov_lm as jmarkov  # noqa: E402
from repro_torch.data import prng  # noqa: E402
from repro_torch.data.pipeline import Loader as TLoader  # noqa: E402
from repro_torch.data.pipeline import make_markov_lm as tmarkov  # noqa: E402

SEEDS = [0, 1, 2, 7, 12345]


def _u32(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.int64) & 0xFFFFFFFF


def _eq(jax_value, torch_value):
    np.testing.assert_array_equal(_u32(jax_value), _u32(torch_value))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bits_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _eq(jk, tk)
    for data in (0, 1, 3, 9176, 2 ** 31 - 1):
        _eq(jax.random.fold_in(jk, data), prng.fold_in(tk, data))
    _eq(jax.random.split(jk), prng.split(tk))
    _eq(jax.random.split(jk, 7), prng.split(tk, 7))
    _eq(jax.random.bits(jk, (5, 3)), prng.bits(tk, (5, 3)))
    _eq(jax.random.bits(jk, (4097,)), prng.bits(tk, 4097))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 512), (3, 100), (0, 1), (-5, 70000)])
def test_randint_bitwise(seed, lo, hi):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.randint(tk, (2000,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (2000,), lo, hi)), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 100, 4096, 1024])
def test_permutation_bitwise(seed, n):
    """n = 4096 is the launcher's training set (2 sort rounds), 1024 its
    test set. No tie among the 32-bit sort keys occurs at these seeds."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.permutation(jk, n)),
                                  prng.permutation(tk, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise_normal_within_4_ulp(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    ju = np.asarray(jax.random.uniform(jk, (20000,)))
    tu = prng.uniform(tk, (20000,)).numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))
    jn = np.asarray(jax.random.normal(jk, (256, 256)))
    tn = prng.normal(tk, (256, 256)).numpy()
    ulp = np.abs(jn.view(np.int32).astype(np.int64)
                 - tn.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4
    np.testing.assert_allclose(tn, jn, rtol=2e-6, atol=1e-7)
    jg = np.asarray(jax.random.gumbel(jk, (256, 256)))
    np.testing.assert_allclose(prng.gumbel(tk, (256, 256)).numpy(), jg,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(), (1,), (7, 3), (64, 16, 16, 3)])
def test_device_path_bitwise_equal_to_the_host_path(shape):
    """The hash in torch int64 ops (``device=``; here on the CPU) gives the
    host path's 32 bits, and so the same uniform and normal values."""
    for seed in (0, 5, 2 ** 31 - 1):
        k = prng.fold_in(prng.PRNGKey(seed), 9176)
        got = prng._bits32(k, shape, device="cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      prng._bits32(k, shape).astype(np.int64))
        for fn in (prng.uniform, prng.normal):
            got, want = fn(k, shape, device="cpu"), fn(k, shape)
            assert got.dtype == want.dtype == torch.float32
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_categorical_matches_on_a_peaked_distribution():
    jk, tk = jax.random.PRNGKey(4), prng.PRNGKey(4)
    logits = np.random.default_rng(0).standard_normal(
        (300, 64)).astype(np.float32) / 0.35
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(jk, logits, axis=-1)),
        prng.categorical(tk, torch.from_numpy(logits), axis=-1).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_markov_lm_tokens_equal_at_launcher_sizes(seed):
    """vocab 512, 4096 x 64 train, 1024 x 64 test: what both launchers
    build. Tokens come from an argmax over floats that agree to a few ulp;
    they are equal at these seeds."""
    kw = dict(vocab=512, n_train=4096, n_test=1024, seq_len=64)
    j, t = jmarkov(seed, **kw), tmarkov(seed, **kw)
    for k in ("train_tokens", "train_labels", "test_tokens", "test_labels"):
        assert t[k].dtype == np.int32
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_allclose(t["transition_logits"],
                               j["transition_logits"], rtol=1e-5, atol=1e-5)


def _arrays(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 50, (n, 8)).astype(np.int32),
            "labels": rng.integers(0, 50, (n, 8)).astype(np.int32)}


@pytest.mark.parametrize("seed,batch", [(0, 16), (3, 25), (11, 7)])
def test_loader_batches_bitwise_across_steps_workers_epochs(seed, batch):
    arrays = _arrays()

    def drops():
        return (pytest.warns(UserWarning, match="drops") if 100 % batch
                else contextlib.nullcontext())
    with drops():
        jl = JLoader(arrays, batch, seed=seed)
    with drops():
        tl = TLoader(arrays, batch, seed=seed)
    assert (tl.steps_per_epoch, tl.dropped_per_epoch) == \
        (jl.steps_per_epoch, jl.dropped_per_epoch)
    for worker in (0, 1, 3):
        for step in list(range(3 * tl.steps_per_epoch)) + [1000]:
            jb, tb = jl.batch(step, worker=worker), tl.batch(step, worker)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))
            assert int(tb["aug_seed"]) == int(jb["aug_seed"])


def test_aug_seed_uint32_wraparound():
    """worker * 9176 + step wraps mod 2**32 in the reference."""
    jl = JLoader(_arrays(), 10, seed=123456)
    tl = TLoader(_arrays(), 10, seed=123456)
    for worker, step in ((0, 0), (5, 17), (468_000, 3), (2 ** 20, 2 ** 31)):
        assert tl.aug_seed(step, worker) == int(
            jl.batch_in_trace(step, worker)["aug_seed"])


@pytest.mark.parametrize("count", [2, 4])
def test_loader_shards_bitwise_and_cover_the_batch(count):
    arrays = _arrays()
    full = TLoader(arrays, 20, seed=5)
    for step in (0, 4, 6):
        parts = []
        for index in range(count):
            jb = JLoader(arrays, 20, seed=5,
                         shard=(index, count)).batch(step, worker=1)
            tb = TLoader(arrays, 20, seed=5,
                         shard=(index, count)).batch(step, 1)
            np.testing.assert_array_equal(tb["tokens"].numpy(),
                                          np.asarray(jb["tokens"]))
            parts.append(tb["tokens"])
        assert torch.equal(torch.cat(parts), full.batch(step, 1)["tokens"])


def test_loader_validation():
    with pytest.raises(ValueError, match="exceeds"):
        TLoader(_arrays(), 200)
    with pytest.raises(ValueError, match="leading dim"):
        TLoader({"a": np.zeros((4, 2)), "b": np.zeros((5, 2))}, 2)
    with pytest.raises(ValueError, match="divisible"):
        TLoader(_arrays(), 10, shard=(0, 3))
    with pytest.raises(ValueError, match="out of range"):
        TLoader(_arrays(), 10, shard=(2, 2))

