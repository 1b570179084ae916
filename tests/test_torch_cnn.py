"""The port's CNN+BatchNorm path against JAX's, on the CPU: the GMM image
data, the augmentation, the CNN's forward (train and eval), BN batch
statistics and grads, and ``CNNAdapter``'s loss, train step and phase-3
``finalize``.

Both packages read the same numpy inputs; JAX params (and BN state) are
carried over with ``params_from_numpy``. Tolerances: the GMM labels and
the cutout mask bitwise; the GMM images and augmented values 4 ulp of
their largest value (they pass through ``normal``); logits, new BN state
and batch statistics 1e-5 of the reference's largest value; the loss
1e-5; grads 1e-4 relative with 1e-6 absolute (sums of products taken in
another order); one f32 train step (params and BN state) 1e-4;
``finalize``'s BN state 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt  # noqa: E402
from repro.configs.base import ScheduleConfig as JSched  # noqa: E402
from repro.core.adapters import CNNAdapter as JAdapter  # noqa: E402
from repro.core.schedules import schedule_fn as jschedule  # noqa: E402
from repro.data.augment import augment_images as jaugment  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_gmm_images as jgmm  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.train import precision as jprec  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import OptimizerConfig  # noqa: E402
from repro_torch.configs.base import ScheduleConfig  # noqa: E402
from repro_torch.core import CNNAdapter  # noqa: E402
from repro_torch.core.schedules import schedule_fn  # noqa: E402
from repro_torch.data.augment import augment_images  # noqa: E402
from repro_torch.data.pipeline import Loader, make_gmm_images  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.train import precision as tprec  # noqa: E402

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STEP_TOL = 1e-4
ARCH = "cifar-cnn"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _scaled_close(t_tree, j_tree, tol):
    """Leaf by leaf: max |t - j| <= tol * max |j|."""
    t, j = _flat(t_tree), _flat(jax.device_get(j_tree))
    assert t.keys() == j.keys()
    for k in j:
        got, want = _np(t[k]), np.asarray(j[k])
        assert got.shape == want.shape, k
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, f"{k}: {err:.3e} > {tol}"


def _allclose(t_tree, j_tree, rtol, atol):
    t, j = _flat(t_tree), _flat(jax.device_get(j_tree))
    assert t.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(_np(t[k]), np.asarray(j[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _assert_within_4_ulp(got, want):
    """|got - want| <= 4 ulp of the largest |want|: a sum such as mean +
    noise * normal cancels near 0, where 4 ulp of normal's output are many
    of the sum's own."""
    ulp = np.spacing(np.abs(want).max().astype(np.float32))
    assert np.abs(got - want).max() <= 4 * ulp


def _bundle(cfg, seed=0):
    """A JAX bundle with BN scale/bias and running stats moved off their
    init values (so eval mode and the affine terms are exercised)."""
    params, state = jcnn.init_cnn(jax.random.PRNGKey(seed), cfg)
    params, state = jax.device_get((params, state))
    rng = np.random.default_rng(seed)
    for name in state:
        c = state[name]["mean"].shape[0]
        params[name]["scale"] = (1 + 0.1 * rng.standard_normal(c)).astype(
            np.float32)
        params[name]["bias"] = (0.1 * rng.standard_normal(c)).astype(
            np.float32)
        state[name] = {
            "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "var": (1 + 0.5 * rng.random(c)).astype(np.float32)}
    return {"params": params, "state": state}


def _images(n=8, size=16, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("seed,n_classes,size,noise",
                         [(0, 10, 16, 1.5), (3, 20, 8, 3.0), (7, 10, 32, 3.5)])
def test_gmm_images_match_jax(seed, n_classes, size, noise):
    kw = dict(n_classes=n_classes, image_size=size, n_train=96, n_test=40,
              noise=noise)
    j, t = jgmm(seed, **kw), make_gmm_images(seed, **kw)
    assert j.keys() == t.keys()
    for split in ("train", "test"):
        np.testing.assert_array_equal(t[f"{split}_labels"],
                                      np.asarray(j[f"{split}_labels"]))
        got, want = t[f"{split}_images"], np.asarray(j[f"{split}_images"])
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        _assert_within_4_ulp(got, want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_augment_cutout_mask_bitwise_values_within_4_ulp(seed):
    ones = np.ones((6, 16, 16, 3), np.float32)
    jmask = np.asarray(jaugment(jnp.asarray(ones), jnp.int32(seed),
                                noise=0.0)) == 0.0
    tmask = augment_images(torch.from_numpy(ones), torch.tensor(
        seed, dtype=torch.int32), noise=0.0).numpy() == 0.0
    np.testing.assert_array_equal(tmask, jmask)
    assert (tmask.all(-1).sum(axis=(1, 2)) == 16).all()   # one 4x4 square
    imgs = _images(6, 16, seed % 97)
    want = np.asarray(jaugment(jnp.asarray(imgs), jnp.int32(seed)))
    got = augment_images(torch.from_numpy(imgs), seed).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    _assert_within_4_ulp(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_apply_cnn_logits_and_state_match_jax(train):
    cfg = jreg.get_smoke_config(ARCH)
    jb = _bundle(cfg)
    tb = params_from_numpy(jb)
    x = _images()
    jl, js = jcnn.apply_cnn(jb["params"], jb["state"], jnp.asarray(x), cfg,
                            train=train)
    tl, ts = cnn.apply_cnn(tb["params"], tb["state"], torch.from_numpy(x),
                           treg.get_smoke_config(ARCH), train=train)
    _scaled_close({"logits": tl}, {"logits": jl}, FWD_TOL)
    _scaled_close(ts, js, FWD_TOL)


def test_cnn_batch_stats_match_jax():
    cfg = jreg.get_smoke_config(ARCH)
    jb = _bundle(cfg, seed=2)
    x = _images(16, seed=3)
    want = jcnn.cnn_batch_stats(jb["params"], jnp.asarray(x), cfg)
    got = cnn.cnn_batch_stats(params_from_numpy(jb["params"]),
                              torch.from_numpy(x),
                              treg.get_smoke_config(ARCH))
    _scaled_close(got, want, FWD_TOL)


def test_cnn_grads_match_jax_grad():
    cfg = jreg.get_smoke_config(ARCH)
    jb = _bundle(cfg, seed=4)
    x = _images(8, seed=5)
    cot = np.random.default_rng(6).standard_normal(
        (8, cfg.n_classes)).astype(np.float32)

    def jloss(p):
        logits, _ = jcnn.apply_cnn(p, jb["state"], jnp.asarray(x), cfg,
                                   train=True)
        return jnp.sum(logits * cot)

    want = jax.grad(jloss)(jb["params"])
    tb = params_from_numpy(jb)
    leaves = [t.requires_grad_() for t in tree_leaves(tb["params"])]
    logits, _ = cnn.apply_cnn(tb["params"], tb["state"], torch.from_numpy(x),
                              treg.get_smoke_config(ARCH), train=True)
    grads = torch.autograd.grad((logits * torch.from_numpy(cot)).sum(),
                                leaves)
    got = dict(zip(sorted(_flat(want)), grads))
    assert all(float(g.abs().max()) > 0 for g in grads)
    _allclose(got, _flat(want), GRAD_RTOL, GRAD_ATOL)


def test_convs_run_in_f32_whatever_the_tf32_flag(monkeypatch):
    """The CNN's convolutions (im2col products) run with the matmuls' f32
    precision set to full f32 whatever the caller set, in the forward and
    in the backward (dx and dw), and give the caller's setting back (the
    card holds the numbers: chip_smoke.py's CNN phase runs the full-width
    forward and grads with TF32 allowed around them)."""
    cfg = treg.get_smoke_config(ARCH)
    params, state = cnn.init_cnn(torch.Generator().manual_seed(0), cfg)
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    seen = {"matmul": [], "addmm_": []}
    matmul, addmm_ = torch.matmul, torch.Tensor.addmm_

    def probe(name, fn):
        def run(*args, **kw):
            seen[name].append(torch.backends.cuda.matmul.fp32_precision)
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(torch, "matmul", probe("matmul", matmul))
    monkeypatch.setattr(torch.Tensor, "addmm_", probe("addmm_", addmm_))
    monkeypatch.setattr(cnn.F, "conv2d", None)    # no cuDNN convolution
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.randn(2, 16, 16, 3, requires_grad=True)
        logits, _ = cnn.apply_cnn(params, state, x, cfg, train=True)
        logits.sum().backward()
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    # 4 convolutions of one slice: y and dx by matmul, dw by addmm_
    assert seen == {"matmul": ["ieee"] * 8, "addmm_": ["ieee"] * 4}
    assert x.grad is not None


@pytest.mark.parametrize("n", [1, cnn._SLICE, 2 * cnn._SLICE + 3])
def test_conv_matches_the_convolution_and_its_backward(n):
    """``_Conv`` (im2col products over slices of ``_SLICE`` images, the
    last one partial at n = 2 * _SLICE + 3) against PyTorch's own
    convolution and its backward, in f64 on the same inputs."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 6, 5, 3, generator=g, dtype=torch.float64)
    w = torch.randn(3, 3, 3, 4, generator=g, dtype=torch.float64)
    gy = torch.randn(n, 6, 5, 4, generator=g, dtype=torch.float64)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = cnn._conv(xs, ws)
    dx, dw = torch.autograd.grad(y, (xs, ws), gy)
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    wdx, wdw, _ = torch.ops.aten.convolution_backward(
        gy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
    torch.testing.assert_close(y, want.permute(0, 2, 3, 1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(dx, wdx.permute(0, 2, 3, 1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(dw, wdw.permute(2, 3, 1, 0), rtol=1e-12,
                               atol=1e-12)


def test_conv_grads_are_taken_only_where_asked():
    """dx is not formed for an input that needs no grad (the first
    convolution's images), and dw's slices sum in a fixed order: two
    backward passes give the same bits."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2 * cnn._SLICE + 1, 4, 4, 3, generator=g)
    w = torch.randn(3, 3, 3, 5, generator=g, requires_grad=True)
    gy = torch.randn(2 * cnn._SLICE + 1, 4, 4, 5, generator=g)
    runs = [torch.autograd.grad(cnn._conv(x, w), (w,), gy)[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == w.shape


def test_cnn_refused_by_model_and_build_model():
    for cfg in (treg.get_smoke_config(ARCH), treg.get_config(ARCH)):
        with pytest.raises(NotImplementedError,
                           match="repro_torch.models.cnn"):
            Model(cfg)
        with pytest.raises(ValueError, match="functional API, not Model"):
            build_model(cfg)
    with pytest.raises(ValueError, match="functional API, not Model"):
        jbuild(jreg.get_smoke_config(ARCH))


class FromJax(CNNAdapter):
    """The port's CNN adapter, initialized with a JAX bundle."""

    def __init__(self, cfg, opt_cfg, jax_bundle):
        super().__init__(cfg, opt_cfg)
        self.jax_bundle = jax.device_get(jax_bundle)

    def init(self, gen):
        return params_from_numpy(self.jax_bundle, device=gen.device)


def _adapters(opt=None):
    jad = JAdapter(jreg.get_smoke_config(ARCH), JOpt(**(opt or {})))
    jb = jad.init(jax.random.PRNGKey(0))
    tad = FromJax(treg.get_smoke_config(ARCH),
                  OptimizerConfig(**(opt or {})), jb)
    return jad, tad, jb


def _data(n_train=128, seed=0):
    d = jgmm(seed, n_classes=10, image_size=16, n_train=n_train, n_test=64,
             noise=2.0)
    return {"images": np.asarray(d["train_images"]),
            "labels": np.asarray(d["train_labels"])}


def test_adapter_loss_with_augmentation_matches_jax():
    jad, tad, jb = _adapters()
    arrays = _data()
    jbatch = JLoader(arrays, 32, seed=5).batch(3, worker=1)
    tbatch = Loader(arrays, 32, seed=5).batch(3, worker=1)
    assert int(jbatch["aug_seed"]) == int(tbatch["aug_seed"])
    jl, (jm, js) = jad._loss(jb["params"], jb["state"], jbatch)
    tb = tad.init(torch.Generator())
    tl, (tm, ts) = tad._loss(tb["params"], tb["state"], tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=FWD_TOL)
    assert abs(float(tm["accuracy"]) - float(jm["accuracy"])) <= 1 / 32
    _scaled_close(ts, js, FWD_TOL)


def test_adapter_f32_steps_match_jax():
    """Two SGD steps (momentum, weight decay) through the precision step:
    params, BN state and momentum to 1e-4."""
    jad, tad, jb = _adapters(dict(kind="sgd", momentum=0.9,
                                  weight_decay=5e-4))
    arrays = _data()
    jl, tl = JLoader(arrays, 32, seed=1), Loader(arrays, 32, seed=1)
    jstep = jax.jit(jad.make_train_step(jschedule(JSched(kind="const",
                                                         peak_lr=0.1))))
    tstep = tad.make_train_step(schedule_fn(ScheduleConfig(kind="const",
                                                           peak_lr=0.1)))
    jo, js = jad.init_opt(jb), jprec.default_scale_state()
    tb = tad.init(torch.Generator())
    to, ts = tad.init_opt(tb), tprec.default_scale_state()
    for step in range(2):
        jb, jo, js, jm = jstep(jb, jo, jl.batch(step), step, js)
        tb, to, ts, tm = tstep(tb, to, tl.batch(step), step, ts)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=STEP_TOL)
    _allclose(tb, jb, STEP_TOL, STEP_TOL)
    _allclose(to, jo, STEP_TOL, STEP_TOL)


def test_bf16_grad_accum_trains_and_keeps_bn_state_f32():
    """The reference's bf16 + accumulation-4 scenario: BN statistics are
    per microbatch; the step trains and the BN state stays f32."""
    cfg = treg.get_smoke_config(ARCH)
    adapter = CNNAdapter(cfg, OptimizerConfig(kind="sgd"))
    d = make_gmm_images(0, n_classes=4, image_size=16, n_train=64, n_test=16,
                        noise=2.0)
    loader = Loader({"images": d["train_images"],
                     "labels": d["train_labels"]}, 32, seed=0)
    step_fn = adapter.make_train_step(
        schedule_fn(ScheduleConfig(kind="const", peak_lr=0.1)),
        policy=tprec.resolve_policy("bf16"), grad_accum_steps=4)
    b0 = adapter.init(torch.Generator().manual_seed(0))
    before = [t.clone() for t in tree_leaves(b0)]
    bundle, _, _, m = step_fn(b0, adapter.init_opt(b0), loader.batch(0), 0,
                              tprec.default_scale_state())
    assert np.isfinite(float(m["loss"]))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        before[:len(tree_leaves(b0["params"]))],
        tree_leaves(bundle["params"])))
    assert moved > 0
    for old, new in zip(before[len(tree_leaves(b0["params"])):],
                        tree_leaves(bundle["state"])):
        assert new.dtype == torch.float32
        assert not torch.equal(old, new)


def test_finalize_recomputes_bn_stats_as_jax():
    jad, tad, jb = _adapters()
    arrays = _data(n_train=256, seed=3)
    want = jad.finalize(jb["params"], JLoader(arrays, 64, seed=2),
                        n_batches=3)
    tb = tad.init(torch.Generator())
    got = tad.finalize(tb["params"], Loader(arrays, 64, seed=2), n_batches=3)
    assert got["params"] is tb["params"]
    _scaled_close(got["state"], want["state"], FWD_TOL)
    acc_t = tad.eval_accuracy(got, Loader(arrays, 64), max_batches=2)
    acc_j = jad.eval_accuracy(want, JLoader(arrays, 64), max_batches=2)
    assert abs(acc_t - acc_j) <= 1 / 64
