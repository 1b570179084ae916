"""The instrument of the CNN's card-against-CPU check
(``cnn_conv_accuracy.py``, used by ``chip_smoke.py``), on the CPU at the
smoke width:

  * recording a forward's branch (ReLU masks, 2x2 and global max choices)
    leaves its logits, BN state and grads bitwise the model's own;
  * replaying an f32 run's branch in f64 takes the grads to within 1e-5 of
    the f32 ones (rounding alone), and the replay follows the recorded
    choices: one flipped ReLU mask moves the grads;
  * the im2col GEMM backward of the 3x3 convolution equals PyTorch's
    convolution backward in f64 (1e-12 of the largest value).
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cnn_conv_accuracy import (Branch, bwd_cudnn, bwd_gemm,  # noqa: E402
                               cnn_grads, rel_err)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


def _model(batch=8, seed=3):
    cfg = registry.get_smoke_config("cifar-cnn")
    g = torch.Generator().manual_seed(seed)
    params, state = cnn.init_cnn(g, cfg)
    x = torch.randn(batch, cfg.image_size, cfg.image_size, 3, generator=g)
    cot = torch.randn(batch, cfg.n_classes, generator=g)
    return params, state, x, cot, cfg


def test_recording_a_branch_keeps_the_model_bitwise():
    model = _model()
    out, grads = cnn_grads(*model, "cpu")
    rec = Branch("record")
    out_r, grads_r = cnn_grads(*model, "cpu", branch=rec)
    assert all(torch.equal(a, b) for a, b in zip(out + grads, out_r + grads_r))
    kinds = [k for k, _ in rec.choices]
    n_convs = sum(1 for k in model[0] if k != "fc")
    n_pools = len(model[4].cnn_channels) - 1
    assert kinds.count("relu") == n_convs
    assert kinds.count("pool") == n_pools and kinds[-1] == "amax"
    assert torch.relu is not rec.relu and cnn._maxpool is not rec.maxpool


def test_replaying_a_branch_follows_its_choices():
    model = _model()
    rec = Branch("record")
    _, f32 = cnn_grads(*model, "cpu", branch=rec)
    _, f64 = cnn_grads(*model, "cpu", torch.float64,
                       branch=Branch("replay", rec.choices))
    assert max(rel_err(a, b) for a, b in zip(f32, f64)) <= 1e-5
    flipped = list(rec.choices)
    kind, mask = flipped[0]
    mask = mask.clone()
    mask.view(-1)[0] = ~mask.view(-1)[0]
    flipped[0] = (kind, mask)
    _, moved = cnn_grads(*model, "cpu", torch.float64,
                         branch=Branch("replay", flipped))
    assert max(rel_err(a, b) for a, b in zip(moved, f64)) > 1e-9


@pytest.mark.parametrize("shape", [(2, 8, 8, 3, 5), (3, 4, 6, 16, 8)])
def test_gemm_backward_matches_the_convolution_backward(shape):
    N, H, W, C, O = shape
    g = torch.Generator().manual_seed(N * H + C)
    x = torch.randn(N, H, W, C, generator=g, dtype=torch.float64)
    w = torch.randn(3, 3, C, O, generator=g, dtype=torch.float64)
    gy = torch.randn(N, H, W, O, generator=g, dtype=torch.float64)
    for got, want in zip(bwd_gemm(x, w, gy), bwd_cudnn(x, w, gy)):
        assert got.shape == want.shape
        assert rel_err(got, want) <= 1e-12
