"""The port's CUDA kernels on the card: each kernel against its plain PyTorch
version on the same inputs. These tests skip where there is no CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

At module level it imports only what the serving slice already had, so the
gradient test of the fused backend also runs against a checkout of that
slice, where it fails (run pytest from inside that checkout's root).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.nn.models import LMModel  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402
from vmlmf_tpu_torch.serve import Decoder  # noqa: E402

# f32 sums over K terms are taken in another order than in the plain version
TOL = dict(atol=1e-4, rtol=1e-4)
# weight gradients are sums over all T*B rows, taken in another order
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)

# (T, B, F, h, rx, r): ragged edges everywhere, F = h, F < h (HAR), F > h
CASES = {
    "f_eq_h": (5, 3, 16, 16, 4, 4),
    "har": (24, 81, 77, 180, 8, 6),
    "f_gt_h": (7, 9, 70, 33, 5, 40),
    "wide": (3, 6, 1600, 1600, 65, 129),  # 4.1 MB of U and V, over 33 CTAs a group
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(t, b, f, h, rx, r, device, seed=0):
    """Seeded scan inputs; rx = 0 gives a dense x side (ux [F, 4h], vx None)
    and r = 0 a dense recurrent side (u [h, 4h], v None)."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(device)

    kx, k = rx or 4 * h, r or 4 * h
    return (n(t, b, f, scale=1.0), n(f, kx, scale=f ** -0.5),
            n(rx, 4 * h, scale=rx ** -0.5) if rx else None,
            n(4, h, scale=0.1), n(4 * h, scale=0.1), n(h, k, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5) if r else None, n(4 * h, scale=0.1),
            n(b, h, scale=0.5), n(b, h, scale=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_scan_kernel_matches_plain(cuda, case):
    args = make_inputs(*CASES[case], cuda)
    before = cuda_scan.lstm_scan_fused_xin.launches
    ys, c_last = cuda_scan.lstm_scan_fused_xin(*args)
    torch.cuda.synchronize()
    assert cuda_scan.lstm_scan_fused_xin.launches == before + 1
    ys_p, c_p = cuda_scan.lstm_scan_fused_xin_plain(*args)
    torch.testing.assert_close(ys, ys_p, **TOL)
    torch.testing.assert_close(c_last, c_p, **TOL)


@pytest.mark.cuda
def test_scan_kernel_raises_on_non_contiguous_input(cuda):
    args = list(make_inputs(*CASES["f_eq_h"], cuda))
    args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_scan.lstm_scan_fused_xin(*args)


@pytest.mark.cuda
def test_fused_prefill_matches_loop_on_cuda(cuda):
    kw = dict(vocab_size=64, hidden_size=40, num_layers=2, dropout_rate=0.0, winit=0.3,
              cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=7, u_rank=9))
    fused, loop = LMModel(backend="fused", **kw), LMModel(backend="loop", **kw)
    params = fused.init(torch.Generator().manual_seed(0), device=cuda)
    prompt = torch.randint(0, 64, (9, 5), generator=torch.Generator().manual_seed(1)).to(cuda)
    before = cuda_scan.lstm_scan_fused_xin.launches
    lf, sf = Decoder(fused).prefill(params, prompt, fused.state0(5, cuda))
    assert cuda_scan.lstm_scan_fused_xin.launches == before + 2
    ll, sl = Decoder(loop).prefill(params, prompt, loop.state0(5, cuda))
    torch.testing.assert_close(lf, ll, **TOL)
    for a, b in zip(sf, sl):
        torch.testing.assert_close(a, b, **TOL)


def residual_and_grads(args, dys, dc_last, fwd, bwd):
    res = fwd(*args)
    saved = (*args[:4], *args[5:], res[0], res[1], res[2], res[3], res[4])
    return res, bwd(*saved, dys, dc_last)


# (T, B, F, h, rx, r) with rx = 0 / r = 0 for a dense side: each dense form at
# ragged small shapes, at the HAR layer (h=180, a 518 KB U over three CTAs)
# and at the PTB LM layer (h=650, 6.8 MB U and Ux)
DENSE_CASES = {
    "dense_rec_f_gt_h": (7, 9, 70, 33, 5, 0),
    "dense_x_f_lt_h": (5, 3, 13, 20, 0, 7),
    "dense_f_eq_h": (5, 3, 16, 16, 0, 0),
    "dense_rec_har": (24, 81, 77, 180, 8, 0),
    "dense_har": (24, 81, 77, 180, 0, 0),
    "dense_lm": (35, 20, 650, 650, 0, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DENSE_CASES), ids=list(DENSE_CASES))
def test_dense_form_kernels_match_plain(cuda, case):
    t, b, f, h, rx, r = DENSE_CASES[case]
    args = make_inputs(t, b, f, h, rx, r, cuda)
    rng = np.random.default_rng(1)
    dys = torch.from_numpy(rng.standard_normal((t, b, h)).astype(np.float32)).to(cuda)
    dc_last = torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32)).to(cuda)
    fns = (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
           cuda_scan.lstm_scan_xin_bwd)
    counts = [fn.launches for fn in fns]
    ys, c_last = cuda_scan.lstm_scan_fused_xin(*args)
    res, grads = residual_and_grads(args, dys, dc_last, cuda_scan.lstm_scan_fused_xin_res,
                                    cuda_scan.lstm_scan_xin_bwd)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fns] == [c + 1 for c in counts]
    res_p, grads_p = residual_and_grads(args, dys, dc_last, cuda_scan.lstm_scan_xin_fwd_res_plain,
                                        cuda_scan.lstm_scan_xin_bwd_plain)
    torch.testing.assert_close(ys, res_p[0], **TOL)
    torch.testing.assert_close(c_last, res_p[1][-1], **TOL)
    for name, got, want in zip(("ys", "cs", "gates", "hu", "xu"), res, res_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **TOL)
    for name, got, want in zip(cuda_scan._ARG_NAMES, grads, grads_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **GRAD_TOL)


@pytest.mark.cuda
def test_lstm_kernels_refuse_bf16(cuda):
    args = list(make_inputs(*DENSE_CASES["dense_f_eq_h"], cuda))
    args[5] = args[5].bfloat16()
    for fn in (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res):
        with pytest.raises(TypeError, match="float32"):
            fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_residual_forward_and_bptt_kernels_match_plain(cuda, case):
    t, b, f, h, rx, r = CASES[case]
    args = make_inputs(t, b, f, h, rx, r, cuda)
    rng = np.random.default_rng(1)
    dys = torch.from_numpy(rng.standard_normal((t, b, h)).astype(np.float32)).to(cuda)
    dc_last = torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32)).to(cuda)
    counts = (cuda_scan.lstm_scan_fused_xin_res.launches, cuda_scan.lstm_scan_xin_bwd.launches)
    res, grads = residual_and_grads(args, dys, dc_last, cuda_scan.lstm_scan_fused_xin_res,
                                    cuda_scan.lstm_scan_xin_bwd)
    torch.cuda.synchronize()
    assert (cuda_scan.lstm_scan_fused_xin_res.launches,
            cuda_scan.lstm_scan_xin_bwd.launches) == (counts[0] + 1, counts[1] + 1)
    res_p, grads_p = residual_and_grads(args, dys, dc_last, cuda_scan.lstm_scan_xin_fwd_res_plain,
                                        cuda_scan.lstm_scan_xin_bwd_plain)
    for name, got, want in zip(("ys", "cs", "gates", "hu", "xu"), res, res_p):
        torch.testing.assert_close(got, want, msg=name, **TOL)
    for name, got, want in zip(cuda_scan._ARG_NAMES, grads, grads_p):
        torch.testing.assert_close(got, want, msg=name, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["dys", "dc_last"])
def test_bptt_kernel_reads_a_missing_cotangent_as_zeros(cuda, given):
    t, b, f, h, rx, r = CASES["f_gt_h"]
    args = make_inputs(t, b, f, h, rx, r, cuda)
    dys = torch.randn(t, b, h, device=cuda) if given == "dys" else None
    dc_last = torch.randn(b, h, device=cuda) if given == "dc_last" else None
    _, grads = residual_and_grads(args, dys, dc_last, cuda_scan.lstm_scan_fused_xin_res,
                                  cuda_scan.lstm_scan_xin_bwd)
    zeros = (torch.zeros(t, b, h, device=cuda) if dys is None else dys,
             torch.zeros(b, h, device=cuda) if dc_last is None else dc_last)
    _, want = residual_and_grads(args, *zeros, cuda_scan.lstm_scan_xin_fwd_res_plain,
                                 cuda_scan.lstm_scan_xin_bwd_plain)
    for name, got, w in zip(cuda_scan._ARG_NAMES, grads, want):
        torch.testing.assert_close(got, w, msg=name, **GRAD_TOL)


@pytest.mark.cuda
def test_no_grad_kernel_refuses_inputs_that_need_a_gradient(cuda):
    args = list(make_inputs(*CASES["f_eq_h"], cuda))
    args[5].requires_grad_(True)
    with pytest.raises(RuntimeError, match="LSTMScanXin"):
        cuda_scan.lstm_scan_fused_xin(*args)
    with torch.no_grad():
        cuda_scan.lstm_scan_fused_xin(*args)


# The layout of the grid kernels at ragged edges: (T, B, F, h, rx, r), with
# B = 1, 3, 5, 257, h = 7, 650, r = 1, 300 or 0 (dense) and the x side
# low-rank (rx = 5) or dense (0): every form; then T = 1 and 2.
GRID_CASES = {
    f"b{b}_h{h}_r{r or 'dense'}_x{rx or 'dense'}": (3, b, 16, h, rx, r)
    for b in (1, 3, 5, 257) for h in (7, 650) for r in (1, 300, 0) for rx in (5, 0)
}
GRID_CASES.update(t1_lowrank=(1, 5, 70, 33, 5, 40), t1_dense=(1, 20, 650, 650, 0, 0),
                  t2_dense_rec=(2, 3, 16, 650, 8, 0), t2_dense_x=(2, 257, 16, 180, 0, 6))


def grid_outputs(args, dys, dc_last):
    """The three entries' outputs on one set of inputs: the no-grad forward,
    the residuals, and the gradients from (dys, dc_last)."""
    fwd = cuda_scan.lstm_scan_fused_xin(*args)
    res, grads = residual_and_grads(args, dys, dc_last, cuda_scan.lstm_scan_fused_xin_res,
                                    cuda_scan.lstm_scan_xin_bwd)
    return fwd, res, grads


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRID_CASES), ids=list(GRID_CASES))
def test_grid_kernels_match_plain_at_ragged_edges(cuda, case):
    t, b, f, h, rx, r = GRID_CASES[case]
    args = make_inputs(t, b, f, h, rx, r, cuda)
    rng = np.random.default_rng(1)
    dys = torch.from_numpy(rng.standard_normal((t, b, h)).astype(np.float32)).to(cuda)
    dc_last = torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32)).to(cuda)
    (ys, c_last), res, _ = grid_outputs(args, dys, dc_last)
    res_p = cuda_scan.lstm_scan_xin_fwd_res_plain(*args)
    torch.testing.assert_close(ys, res_p[0], **TOL)
    torch.testing.assert_close(c_last, res_p[1][-1], **TOL)
    for name, got, want in zip(("ys", "cs", "gates", "hu", "xu"), res, res_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **TOL)
    saved = (*args[:4], *args[5:], *res)
    for cot in ((dys, dc_last), (None, dc_last), (dys, None)):
        grads = cuda_scan.lstm_scan_xin_bwd(*saved, *cot)
        grads_p = cuda_scan.lstm_scan_xin_bwd_plain(*saved, *cot)
        for name, got, want in zip(cuda_scan._ARG_NAMES, grads, grads_p):
            assert (got is None) == (want is None), name
            if want is not None:
                torch.testing.assert_close(got, want, msg=name, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(35, 20, 650, 650, 300, 300), (35, 20, 650, 650, 0, 0),
                                   (24, 81, 77, 180, 8, 0)], ids=["lm", "lm_dense", "har_group"])
def test_grid_kernels_are_deterministic(cuda, shape):
    # every sum runs in a fixed order inside one CTA: no atomics
    args = make_inputs(*shape, cuda)
    dys = torch.randn(shape[0], shape[1], shape[3], device=cuda)
    first, second = grid_outputs(args, dys, None), grid_outputs(args, dys, None)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


@pytest.mark.cuda
def test_grid_too_large_to_be_co_resident_raises(cuda, monkeypatch):
    # 5 groups of 60 CTAs: more CTAs than the card can hold at once
    monkeypatch.setattr(cuda_scan, "_chunks_for", lambda b, h, r, device, bf16=False:
                        ((0, b, cuda_scan.plan_layout(b, h, r, 5, 60)),))
    args = make_inputs(3, 5, 16, 650, 5, 300, cuda)
    for fn in (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(*args)


def lm_and_batch(cuda, backend):
    model = LMModel(vocab_size=64, hidden_size=40, num_layers=2, dropout_rate=0.0, winit=0.3,
                    backend=backend, cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=7, u_rank=9))
    g = torch.Generator().manual_seed(1)
    x, y = (torch.randint(0, 64, (9, 5), generator=g).to(cuda) for _ in range(2))
    return model, x, y


@pytest.mark.cuda
def test_fused_training_gives_every_cell_parameter_a_gradient(cuda):
    # on the card the no-grad kernel once left every cell parameter without
    # a gradient while the embedding and the head trained
    model, x, y = lm_and_batch(cuda, "fused")
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    for p in (params["embed"]["w"], *params["fc"].values(),
              *(q for cell in params["rnn"] for q in cell.values())):
        p.requires_grad_(True)
    logits, _ = model.apply(params, x, model.state0(5, cuda), train=True)
    torch.nn.functional.cross_entropy(logits.reshape(-1, 64), y.reshape(-1)).backward()
    assert params["embed"]["w"].grad is not None and params["fc"]["w"].grad is not None
    for layer, cell in enumerate(params["rnn"]):
        for name, p in cell.items():
            assert p.grad is not None, (layer, name)
            assert bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().max()) > 0, (
                layer, name)


@pytest.mark.cuda
def test_fused_train_step_matches_loop_backend_on_cuda(cuda):
    from vmlmf_tpu_torch.train.lm import LMTrainer, lm_loss
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    grads, losses = [], []
    for backend in ("fused", "loop"):
        model, x, y = lm_and_batch(cuda, backend)
        trainer = LMTrainer(model, batch_size=5, seq_length=9, device=cuda)
        params = trainer.init()
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        logits, _ = model.apply(params, x, trainer.state0(), train=True)
        loss = lm_loss(logits, y)
        grads.append(torch.autograd.grad(loss, leaves))
        losses.append(loss)
    torch.testing.assert_close(losses[0], losses[1], **TOL)
    for fused, loop in zip(*grads):
        # against each tensor's own scale, which is far from 1 at this init
        scale = float(loop.abs().max())
        assert scale > 0
        assert float((fused - loop).abs().max()) <= GRAD_TOL["rtol"] * scale


@pytest.mark.cuda
def test_har_trainer_runs_on_cuda(cuda):
    from vmlmf_tpu_torch.nn.models import HARNet
    from vmlmf_tpu_torch.train.har import HARTrainer

    model = HARNet(77, (180,), num_classes=18,
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=8, u_rank=6))
    trainer = HARTrainer(model, batch_size=81, device=cuda)
    params, opt = trainer.init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((81, 24, 77)).astype(np.float32)
    y = rng.integers(0, 18, 81).astype(np.int32)
    losses = [float(trainer.train_step(params, opt, x, y)[2]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# -- the GRU scan (ops/cuda_gru.py)

# (T, B, F, h, rx, r, mode, low-rank recurrent side): the HAR GRU layers at
# the train batch B=81 and at evaluate's B=256 (two rows a CTA), one batch
# row (one CTA), ragged small shapes, and a dense and a low-rank form too
# large for shared memory
GRU_CASES = {
    "main_l1": (24, 81, 77, 64, 9, 9, "pre", True),
    "main_l2": (24, 81, 64, 64, 9, 9, "pre", True),
    "group_post": (24, 81, 77, 64, 9, 0, "post", False),
    "group_l2": (24, 81, 64, 64, 9, 0, "post", False),
    "main_l1_b256": (24, 256, 77, 64, 9, 9, "pre", True),
    "group_post_b256": (24, 256, 77, 64, 9, 0, "post", False),
    "dense_pre_b256": (24, 256, 77, 64, 9, 0, "pre", False),
    "main_l1_b1": (24, 1, 77, 64, 9, 9, "pre", True),
    "group_post_b1": (24, 1, 77, 64, 9, 0, "post", False),
    "ragged_h_post": (6, 7, 13, 37, 3, 0, "post", False),
    "ragged_h_lowrank": (5, 530, 11, 21, 2, 5, "pre", True),  # four rows a CTA, a ragged last
    # past the widths whose lane shares fit in registers: weights in shared memory
    "shared_post": (6, 9, 20, 96, 5, 0, "post", False),
    "shared_dense_pre": (5, 7, 11, 80, 0, 0, "pre", False),
    "dense_pre": (7, 9, 20, 33, 5, 0, "pre", False),
    "ragged_lowrank": (5, 3, 13, 40, 6, 33, "pre", True),
    "wide_post": (4, 6, 48, 256, 8, 0, "post", False),  # 768 KB of weights: read through L2
    "wide_lowrank": (4, 6, 48, 256, 8, 64, "pre", True),  # 256 KB of weights: read through L2
    # a dense x side (rx = 0: ux [F, 3h], vx None) in each recurrent form
    "dense_x_main_l1": (24, 81, 77, 64, 0, 9, "pre", True),
    "dense_x_group_post": (24, 81, 77, 64, 0, 0, "post", False),
    "dense_x_dense_pre": (7, 9, 20, 33, 0, 0, "pre", False),
    "dense_x_group_post_b256": (24, 256, 77, 64, 0, 0, "post", False),
}


def gru_inputs(t, b, f, h, rx, r, mode, lowrank, device, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(device)

    k = r if lowrank else h
    return (n(t, b, f, scale=1.0), n(f, rx or 3 * h, scale=f ** -0.5),
            n(rx, 3 * h, scale=rx ** -0.5) if rx else None,
            n(3 * h, scale=0.1), n(h, r, scale=h ** -0.5) if lowrank else None,
            n(k, 2 * h, scale=k ** -0.5), n(k, h, scale=k ** -0.5), n(b, h, scale=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRU_CASES), ids=list(GRU_CASES))
def test_gru_kernels_match_plain(cuda, case):
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = GRU_CASES[case]
    args = gru_inputs(*GRU_CASES[case], cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    counts = [fn.launches for fn in (cuda_gru.gru_scan_fused_xin, cuda_gru.gru_scan_fused_xin_res,
                                     cuda_gru.gru_scan_xin_bwd)]
    ys = cuda_gru.gru_scan_fused_xin(*args, mode=mode)
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    saved = (*args[:3], *args[4:], *res)
    grads = cuda_gru.gru_scan_xin_bwd(*saved, dys, mode=mode)
    no_dx = cuda_gru.gru_scan_xin_bwd(*saved, dys, mode=mode, dx=False)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (cuda_gru.gru_scan_fused_xin, cuda_gru.gru_scan_fused_xin_res,
                                   cuda_gru.gru_scan_xin_bwd)] == [
        counts[0] + 1, counts[1] + 1, counts[2] + 2]
    res_p = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode)
    torch.testing.assert_close(ys, res_p[0], **TOL)
    for name, got, want in zip(("ys", "gates", "hu", "rhu", "recn", "xu"), res, res_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **TOL)
    names = ("dxs", "dux", "dvx", "dbias", "duf", "dprz", "dpn", "dh0")
    grads_p = cuda_gru.gru_scan_xin_bwd_plain(*saved[:13], dys, mode=mode)
    for name, got, skip, want in zip(names, grads, no_dx, grads_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **GRAD_TOL)
            if name != "dxs":
                assert torch.equal(skip, got), name  # the same sums in the same order
    assert no_dx[0] is None


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRU_CASES), ids=list(GRU_CASES))
def test_gru_gi_mode_and_recompute_kernels_match_plain(cuda, case):
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = GRU_CASES[case]
    args = gru_inputs(*GRU_CASES[case], cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    # gi mode, from the layer's own input contribution
    gi = cuda_gru._x_side(args[0], args[1], args[2], args[3])[1].contiguous()
    rec = (gi, *args[4:])
    ys = cuda_gru.gru_scan_fused(*rec, mode=mode)
    res = cuda_gru.gru_scan_fused_res(*rec, mode=mode)
    grads = cuda_gru.gru_scan_bwd(*args[4:], *res, dys, mode=mode)
    torch.cuda.synchronize()
    res_p = cuda_gru.gru_recurrence_plain(*rec, mode=mode)
    torch.testing.assert_close(ys, res_p[0], **TOL)
    for got, want in zip(res, res_p):
        assert (got is None) == (want is None)
        if want is not None:
            torch.testing.assert_close(got, want, **TOL)
    for got, want in zip(grads, cuda_gru.gru_scan_bwd_plain(*args[4:], *res_p, dys, mode=mode)):
        assert (got is None) == (want is None)
        if want is not None:
            torch.testing.assert_close(got, want, **GRAD_TOL)
    # the recompute policy: the forward stores ys alone, the BPTT rebuilds the rest
    ys_rc, *none = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=False)
    assert all(a is None for a in none)
    saved = (*args[:3], *args[4:], ys_rc, *none)
    grads = cuda_gru.gru_scan_xin_bwd(*saved, dys, mode=mode, bias=args[3])
    torch.cuda.synchronize()
    want = cuda_gru.gru_scan_xin_bwd_plain(*saved, dys, mode=mode, bias=args[3])
    for got, w in zip(grads, want):
        assert (got is None) == (w is None)
        if w is not None:
            torch.testing.assert_close(got, w, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRU_CASES), ids=list(GRU_CASES))
def test_gru_kernels_give_equal_bits_and_count_one_launch_a_call(cuda, case):
    """Every GRU entry, in each policy, twice on the same inputs: the same
    bits (fixed-order sums, split-k included, no atomics), and one launch
    counted per call."""
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = GRU_CASES[case]
    args = gru_inputs(*GRU_CASES[case], cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    gi = cuda_gru._x_side(*args[:4])[1].contiguous()
    rec = (gi, *args[4:])

    def res_saved():
        res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=True)
        return (*res, *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode))

    def recompute():
        res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=False)
        return (*res, *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode,
                                                 bias=args[3]))

    def gi_mode():
        res = cuda_gru.gru_scan_fused_res(*rec, mode=mode)
        return (cuda_gru.gru_scan_fused(*rec, mode=mode), *res,
                *cuda_gru.gru_scan_bwd(*args[4:], *res, dys, mode=mode))

    calls = {"nograd": lambda: (cuda_gru.gru_scan_fused_xin(*args, mode=mode),),
             "saved": res_saved, "recompute": recompute, "gi": gi_mode}
    entries = (cuda_gru.gru_scan_fused_xin, cuda_gru.gru_scan_fused_xin_res,
               cuda_gru.gru_scan_xin_bwd, cuda_gru.gru_scan_fused, cuda_gru.gru_scan_fused_res,
               cuda_gru.gru_scan_bwd)
    # launches of each entry per call of each policy
    want = {"nograd": (1, 0, 0, 0, 0, 0), "saved": (0, 1, 1, 0, 0, 0),
            "recompute": (0, 1, 1, 0, 0, 0), "gi": (0, 0, 0, 1, 1, 1)}
    for name, call in calls.items():
        before = [fn.launches for fn in entries]
        first, second = call(), call()
        torch.cuda.synchronize()
        assert [fn.launches - n for fn, n in zip(entries, before)] == [2 * w for w in want[name]]
        assert len(first) == len(second)
        for i, (x1, x2) in enumerate(zip(first, second)):
            assert (x1 is None) == (x2 is None), (name, i)
            if x1 is not None:
                assert bool(torch.isfinite(x1).all()), (name, i)
                assert torch.equal(x1, x2), (name, i)


@pytest.mark.cuda
def test_gru_wrappers_refuse_what_the_kernels_do_not_take(cuda, monkeypatch):
    from vmlmf_tpu_torch.ops import cuda_gru

    args = list(gru_inputs(*GRU_CASES["dense_pre"], cuda))
    args[5].requires_grad_(True)
    with pytest.raises(RuntimeError, match="GRUScanXin"):
        cuda_gru.gru_scan_fused_xin(*args, mode="pre")
    with torch.no_grad():
        cuda_gru.gru_scan_fused_xin(*args, mode="pre")
    args[5] = args[5].detach()
    bf16 = [*args[:5], args[5].bfloat16(), *args[6:]]
    with pytest.raises(TypeError, match="float32"):
        cuda_gru.gru_scan_fused_xin(*bf16, mode="pre")
    # the recompute policy is taken: ys alone from the forward, and a BPTT
    # that needs the bias in place of the residuals
    monkeypatch.setenv("VMLMF_PALLAS_SAVED_GATES", "0")
    ys, *res = cuda_gru.gru_scan_fused_xin_res(*args, mode="pre")
    assert all(a is None for a in res)
    assert cuda_gru.gru_scan_fused_xin_res.variants["recompute"] > 0
    with pytest.raises(ValueError, match="bias"):
        cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], ys, *res, torch.zeros_like(ys),
                                  mode="pre")
    monkeypatch.delenv("VMLMF_PALLAS_SAVED_GATES")
    args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru.gru_scan_fused_xin(*args, mode="pre")


def gru_har(backend, group):
    from vmlmf_tpu_torch.cells import GRUCell, GRUGroupCell
    from vmlmf_tpu_torch.nn.models import HARNet

    if group:
        def factory(n, h):
            return GRUGroupCell(n, h, w_rank=9, u_ranks=(12, 6), groups=2)
    else:
        def factory(n, h):
            return GRUCell(n, h, w_rank=9, u_rank=9)
    return HARNet(77, (64, 64), num_classes=18, backend=backend, cell_factory=factory)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [False, True], ids=["lowrank", "group"])
def test_fused_gru_training_gives_every_cell_parameter_the_loop_gradient(cuda, group):
    from vmlmf_tpu_torch.ops import cuda_gru
    from vmlmf_tpu_torch.train.har import cross_entropy

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((81, 24, 77)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 18, 81)).to(cuda)
    grads = []
    for backend in ("fused", "loop"):
        model = gru_har(backend, group)
        params = model.init(torch.Generator().manual_seed(0), device=cuda)
        cells = [p for cell in params["rnn"] for p in cell.values()]
        for p in cells:
            p.requires_grad_(True)
        before = cuda_gru.gru_scan_xin_bwd.launches
        cross_entropy(model.apply(params, x), y).backward()
        assert cuda_gru.gru_scan_xin_bwd.launches - before == (2 if backend == "fused" else 0)
        grads.append([p.grad for p in cells])
    for fused, loop in zip(*grads):
        assert fused is not None and bool(torch.isfinite(fused).all())
        scale = float(loop.abs().max())
        assert scale > 0
        assert float((fused - loop).abs().max()) <= GRAD_TOL["rtol"] * scale


@pytest.mark.cuda
def test_har_trainer_runs_the_gru_harnet_on_cuda(cuda):
    from vmlmf_tpu_torch.ops import cuda_gru
    from vmlmf_tpu_torch.train.har import HARTrainer, evaluate

    model = gru_har("fused", False)
    trainer = HARTrainer(model, batch_size=81, device=cuda)
    params, opt = trainer.init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((81, 24, 77)).astype(np.float32)
    y = rng.integers(0, 18, 81).astype(np.int32)
    losses = [float(trainer.train_step(params, opt, x, y)[2]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    before = cuda_gru.gru_scan_fused_xin.launches
    metrics = evaluate(model, params, x, y, batch_size=81)
    assert cuda_gru.gru_scan_fused_xin.launches - before == 2
    assert 0.0 <= metrics["accuracy"] <= 1.0


# -- the LSTM-family cells through the dense forms, fused against loop

def lstm_family_har(backend, kind):
    from vmlmf_tpu_torch.config import HARConfig

    cfg = {"dense": HARConfig(),
           "group": HARConfig(model="vmgroup", w_rank=8, u_ranks=(2, 4)),
           "dualdiag": HARConfig(model="dualdiag"),
           "mylstm_group": HARConfig(model="mylstm_group", u_ranks=(2, 4))}[kind]
    cfg.backend = backend
    return cfg.build_model()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "group", "dualdiag", "mylstm_group"])
def test_fused_lstm_family_training_gives_every_cell_parameter_the_loop_gradient(cuda, kind):
    from vmlmf_tpu_torch.train.har import cross_entropy

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((81, 24, 77)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 18, 81)).to(cuda)
    grads, logits = [], []
    for backend in ("fused", "loop"):
        model = lstm_family_har(backend, kind)
        params = model.init(torch.Generator().manual_seed(0), device=cuda)
        cells = [p for cell in params["rnn"] for p in cell.values()]
        for p in cells:
            p.requires_grad_(True)
        before = cuda_scan.lstm_scan_xin_bwd.launches
        out = model.apply(params, x)
        cross_entropy(out, y).backward()
        assert cuda_scan.lstm_scan_xin_bwd.launches - before == (backend == "fused")
        grads.append([p.grad for p in cells])
        logits.append(out.detach())
    torch.testing.assert_close(logits[0], logits[1], **TOL)
    for fused, loop in zip(*grads):
        assert fused is not None and bool(torch.isfinite(fused).all())
        scale = float(loop.abs().max())
        assert scale > 0
        assert float((fused - loop).abs().max()) <= GRAD_TOL["rtol"] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["diag", "lstm_group_shuffle", "deepconv"])
def test_cells_run_their_route_on_cuda(cuda, kind):
    # diag and the shuffled group cell have no fused form: under "fused" they
    # run the loop and launch nothing; DeepConvNet runs the dense kernels
    from vmlmf_tpu_torch.cells import LSTMGroupCell
    from vmlmf_tpu_torch.config import HARConfig
    from vmlmf_tpu_torch.nn.models import HARNet
    from vmlmf_tpu_torch.ops import cuda_gru

    def build(backend):
        if kind == "lstm_group_shuffle":
            return HARNet(77, (30,), num_classes=18, backend=backend, cell_factory=lambda n, h:
                          LSTMGroupCell(n, h, u_ranks=(2, 2, 2), groups=3, shuffle=True))
        cfg = HARConfig(model="mylstm" if kind == "deepconv" else kind, deepconv=kind == "deepconv",
                        layer_sizes=(32,), backend=backend)
        return cfg.build_model()

    fns = (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
           cuda_scan.lstm_scan_xin_bwd, cuda_gru.gru_scan_fused_xin,
           cuda_gru.gru_scan_fused_xin_res, cuda_gru.gru_scan_xin_bwd)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((9, 24, 77)).astype(
        np.float32)).to(cuda)
    params = build("fused").init(torch.Generator().manual_seed(0), device=cuda)
    before = [fn.launches for fn in fns]
    with torch.no_grad():
        fused = build("fused").apply(params, x)
    torch.cuda.synchronize()
    launched = [fn.launches - b for fn, b in zip(fns, before)]
    assert launched == ([1, 0, 0, 0, 0, 0] if kind == "deepconv" else [0] * 6)
    with torch.no_grad():
        torch.testing.assert_close(fused, build("loop").apply(params, x), **TOL)


# -- the wavefront stack (csrc/lstm_stack_fwd.cu, csrc/lstm_stack_bwd.cu) -------

# (layers, T, B, h, ranks r_l, x ranks rx_l, masks), each laid out by
# cuda_stack.stack_plan: one CTA a layer (small h), three layers, unequal
# ranks, a ragged h over many CTAs with ranks below the CTA count, the PTB
# LM stack at B = 1, 20 and 128 (one group of 44 + 88 CTAs in f32), and a
# batch that runs in two chunks of rows (cuda_stack.stack_chunks)
STACK_CASES = {
    "l3_ragged": (3, 7, 5, 33, (6, 9, 4), (5, 7), True),
    "l2_one_block": (2, 4, 3, 16, (4, 4), (4,), False),
    "l2_three_blocks": (2, 12, 6, 20, (3, 5), (4,), True),
    "l3_ragged_h_wide": (3, 6, 9, 611, (37, 200, 9), (13, 150), True),
    "lm_b1": (2, 35, 1, 650, (300, 300), (300,), False),
    "lm_b20": (2, 35, 20, 650, (300, 300), (300,), True),
    "lm_b128": (2, 35, 128, 650, (300, 300), (300,), True),
    "lm_b300_chunks": (2, 5, 300, 650, (300, 300), (300,), True),  # two launches of 150 rows
}


def stack_inputs(n, t, b, h, ranks, xranks, masks, device, seed=0):
    """Seeded inputs of the stack, scaled so that the gates are O(1)."""
    rng = np.random.default_rng(seed)

    def g(*shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(device)

    layers = []
    for l in range(n):
        d = {"u": g(h, ranks[l], scale=h ** -0.5), "v": g(ranks[l], 4 * h, scale=ranks[l] ** -0.5),
             "dvec": g(4 * h, scale=0.1)}
        if l:
            rx = xranks[l - 1]
            d.update(ux=g(h, rx, scale=h ** -0.5), vx=g(rx, 4 * h, scale=rx ** -0.5),
                     dxvec=g(4 * h, scale=0.1), bias=g(4 * h, scale=0.1))
        layers.append(d)
    mk = None
    if masks:
        mk = [(torch.from_numpy(rng.random((t, b, h)) < 0.5).float() / 0.5).to(device)
              for _ in range(n - 1)]
    return (g(t, b, 4 * h, scale=1.0), layers, [g(b, h, scale=0.5) for _ in range(n)],
            [g(b, h, scale=0.5) for _ in range(n)], mk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STACK_CASES), ids=list(STACK_CASES))
def test_stack_kernels_match_plain(cuda, case):
    from vmlmf_tpu_torch.ops import cuda_stack

    n, t, b, h, ranks, xranks, masks = STACK_CASES[case]
    gi0, layers, h0s, c0s, mk = stack_inputs(n, t, b, h, ranks, xranks, masks, cuda)
    fns = (cuda_stack.lstm_stack_scan_fused, cuda_stack.lstm_stack_scan_fused_res,
           cuda_stack.lstm_stack_bwd)
    counts = [fn.launches for fn in fns]
    ys, hl, cl = cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s, mk)
    res = cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk)
    rng = np.random.default_rng(1)
    dys = torch.from_numpy(rng.standard_normal((t, b, h)).astype(np.float32)).to(cuda)
    dhl = [torch.randn(b, h, device=cuda), None] + [None] * (n - 2)
    dcl = [None] + [torch.randn(b, h, device=cuda) for _ in range(n - 1)]
    grads = cuda_stack.lstm_stack_bwd(layers, h0s, c0s, mk, *res, dys, dhl, dcl)
    torch.cuda.synchronize()
    # one launch a chunk of rows: one, or two for lm_b300_chunks
    chunks = cuda_stack.stack_chunks(b, h, ranks, xranks, cuda_stack._sm_count(gi0.device.index))
    assert len(chunks) == (2 if b == 300 else 1)
    assert [fn.launches for fn in fns] == [c + len(chunks) for c in counts]

    ys_p, hl_p, cl_p = cuda_stack.lstm_stack_scan_fused_plain(gi0, layers, h0s, c0s, mk)
    for got, want in zip([ys, *hl, *cl], [ys_p, *hl_p, *cl_p]):
        torch.testing.assert_close(got, want, **TOL)
    res_p = cuda_stack.lstm_stack_fwd_res_plain(gi0, layers, h0s, c0s, mk)
    for name, got, want in zip(("ys", "cs", "gates", "hu", "xu"), res, res_p):
        for l, (a, w) in enumerate(zip(got, want)):
            torch.testing.assert_close(a, w, msg=f"{name} {l}", **TOL)
    grads_p = cuda_stack.lstm_stack_bwd_plain(layers, h0s, c0s, mk, *res_p, dys, dhl, dcl)
    for a, w in zip(leaves(grads), leaves(grads_p)):
        torch.testing.assert_close(a, w, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STACK_CASES), ids=list(STACK_CASES))
def test_bf16_stack_kernels_match_plain(cuda, case):
    # bf16 products: the kernel and its plain version round the same
    # operands; sums in another order can move a value across a rounding
    # boundary, hence the bf16 tolerances (tests/test_pallas.py:97, :114)
    from vmlmf_tpu_torch.ops import cuda_stack

    n, t, b, h, ranks, xranks, masks = STACK_CASES[case]
    gi0, layers, h0s, c0s, mk = stack_inputs(n, t, b, h, ranks, xranks, masks, cuda)
    tol, grad_tol = dict(atol=5e-3, rtol=5e-3), dict(atol=5e-2, rtol=5e-2)
    out = cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s, mk, "bf16")
    res = cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk, "bf16")
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    none = [None] * n
    grads = cuda_stack.lstm_stack_bwd(layers, h0s, c0s, mk, *res, dys, none, none, "bf16")
    torch.cuda.synchronize()
    for a, w in zip(leaves(out), leaves(cuda_stack.lstm_stack_scan_fused_plain(
            gi0, layers, h0s, c0s, mk, "bf16"))):
        torch.testing.assert_close(a, w, **tol)
    res_p = cuda_stack.lstm_stack_fwd_res_plain(gi0, layers, h0s, c0s, mk, "bf16")
    for a, w in zip(leaves(res), leaves(res_p)):
        torch.testing.assert_close(a, w, **tol)
    # the gradients, held to the plain version and, at the same tolerance,
    # to the plain version with its f32 sums taken in float64 (the same bf16
    # roundings); where the f32 plain itself is not within the tolerance of
    # its float64 sums (at B=128 one dU element of 195,000), the float64
    # one is the reference
    want = leaves(cuda_stack.lstm_stack_bwd_plain(layers, h0s, c0s, mk, *res, dys, none, none,
                                                  "bf16"))
    wide = lambda tree: [None if a is None else a.double() for a in tree]  # noqa: E731
    own = leaves(cuda_stack.lstm_stack_bwd_plain(
        [{k: a.double() for k, a in lay.items()} for lay in layers], wide(h0s), wide(c0s),
        None if mk is None else wide(mk), *(wide(g) for g in res), dys.double(), none, none,
        "bf16"))
    for i, (a, w, w64) in enumerate(zip(leaves(grads), want, own)):
        torch.testing.assert_close(a.double(), w64, msg=lambda m: f"gradient {i} vs the float64 "
                                   f"plain: {m}", **grad_tol)
        if torch.allclose(w.double(), w64, **grad_tol):
            torch.testing.assert_close(a, w, msg=lambda m: f"gradient {i}: {m}", **grad_tol)


def stack_outputs(case, cuda, precision="f32"):
    """Every output of the stack's three entries on the case's inputs."""
    from vmlmf_tpu_torch.ops import cuda_stack

    n, t, b, h, ranks, xranks, masks = STACK_CASES[case]
    gi0, layers, h0s, c0s, mk = stack_inputs(n, t, b, h, ranks, xranks, masks, cuda)
    out = cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s, mk, precision)
    res = cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk, precision)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    dhl = [torch.ones(b, h, device=cuda)] + [None] * (n - 1)
    grads = cuda_stack.lstm_stack_bwd(layers, h0s, c0s, mk, *res, dys, dhl, [None] * n,
                                      precision)
    torch.cuda.synchronize()
    return leaves([out, res, grads])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["l3_ragged_h_wide", "lm_b20"])
def test_stack_kernels_are_deterministic(cuda, case, precision):
    # every sum runs in a fixed order inside one CTA: no atomics
    first, second = stack_outputs(case, cuda, precision), stack_outputs(case, cuda, precision)
    assert len(first) == len(second)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_stack_entries_are_one_cooperative_launch_each(cuda):
    """The forward is one launch of stack_fwd_kernel; the BPTT one launch of
    stack_bwd_kernel, then the weight GEMMs and column sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stack_outputs("lm_b20", cuda)  # built and warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stack_outputs("lm_b20", cuda)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    fwd = [k for k in names if "stack_fwd_kernel" in k]
    bwd = [k for k in names if "stack_bwd_kernel" in k]
    assert len(fwd) == 2 and len(bwd) == 1, names  # no-grad and residual forwards, one walk
    assert not [k for k in names if "stack_step_kernel" in k]  # no launch per step


@pytest.mark.cuda
def test_stack_plan_too_large_to_be_co_resident_raises(cuda, monkeypatch):
    # a plan for 264 SMs on a card of 132: more CTAs than it can hold at once
    from vmlmf_tpu_torch.ops import cuda_stack

    monkeypatch.setattr(cuda_stack, "_sm_count", lambda index: 264)
    n, t, b, h, ranks, xranks, masks = STACK_CASES["lm_b1"]
    gi0, layers, h0s, c0s, mk = stack_inputs(n, t, b, h, ranks, xranks, masks, cuda)
    assert cuda_stack.stack_plan(b, h, ranks, xranks, 264).n_ctas > 132
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s, mk)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk)


# the LM stack's BPTT at B = 1, 20, 128 and 256 (two chunks of rows in f32,
# one in bf16): its weight gradients on csrc/gemm_tc.cuh's tiles
STACK_TC_BATCHES = (1, 20, 128, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("masks", [True, False], ids=["masks", "no_masks"])
@pytest.mark.parametrize("b", STACK_TC_BATCHES)
def test_stack_bwd_on_the_tensor_cores_matches_plain_and_repeats(cuda, b, masks, precision):
    """lstm_stack_bwd from the kernel's residuals against its plain version:
    GRAD_TOL in f32 (3xTF32 keeps f32's precision), in bf16 the bf16
    tolerances against the plain version and its float64 sums (as
    test_bf16_stack_kernels_match_plain); two calls to equal bits."""
    from vmlmf_tpu_torch.ops import cuda_stack

    n, t, h, ranks, xranks = 2, 35, 650, (300, 300), (300,)
    gi0, layers, h0s, c0s, mk = stack_inputs(n, t, b, h, ranks, xranks, masks, cuda)
    bf16 = precision == "bf16"
    chunks = cuda_stack.stack_chunks(b, h, ranks, xranks, cuda_stack._sm_count(cuda.index),
                                     2 if bf16 else 4)
    assert len(chunks) == (2 if b == 256 and not bf16 else 1)
    res = cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk, precision)
    dys = torch.from_numpy((0.1 if bf16 else 1.0) * np.random.default_rng(1).standard_normal(
        (t, b, h)).astype(np.float32)).to(cuda)
    none = [None] * n
    args = (layers, h0s, c0s, mk, *res, dys, none, none, precision)
    before = cuda_stack.lstm_stack_bwd.launches
    first, second = (leaves(cuda_stack.lstm_stack_bwd(*args)) for _ in range(2))
    torch.cuda.synchronize()
    assert cuda_stack.lstm_stack_bwd.launches == before + 2 * len(chunks)
    for a, w in zip(first, second):
        assert torch.equal(a, w)
    want = leaves(cuda_stack.lstm_stack_bwd_plain(*args))
    if not bf16:
        for i, (a, w) in enumerate(zip(first, want)):
            torch.testing.assert_close(a, w, msg=lambda m: f"gradient {i}: {m}", **GRAD_TOL)
        return
    grad_tol = dict(atol=5e-2, rtol=5e-2)
    wide = lambda tree: [None if a is None else a.double() for a in tree]  # noqa: E731
    own = leaves(cuda_stack.lstm_stack_bwd_plain(
        [{k: a.double() for k, a in lay.items()} for lay in layers], wide(h0s), wide(c0s),
        None if mk is None else wide(mk), *(wide(g) for g in res), dys.double(), none, none,
        "bf16"))
    for i, (a, w, w64) in enumerate(zip(first, want, own)):
        torch.testing.assert_close(a.double(), w64, msg=lambda m: f"gradient {i} vs the float64 "
                                   f"plain: {m}", **grad_tol)
        if torch.allclose(w.double(), w64, **grad_tol):
            torch.testing.assert_close(a, w, msg=lambda m: f"gradient {i}: {m}", **grad_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("b", (1, 20, 128))
def test_stack_bwd_runs_each_weight_gradient_on_its_routed_tile(cuda, b, precision):
    """In a trace of one BPTT call: one wg_gemm_kernel for each product that
    gemm_tc.cuh's rule sends to the Hopper tile (cuda_scan.tc_route: all
    six at B=128, both layers' dV and dVx at B=20, none at B=1), one
    tc_gemm_kernel (mma.sync) for each other, the masked input's pass once,
    and no kernel of gemm_tile.cuh."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vmlmf_tpu_torch.ops import cuda_stack

    n, t, h, ranks, xranks = 2, 35, 650, (300, 300), (300,)
    gi0, layers, h0s, c0s, mk = stack_inputs(n, t, b, h, ranks, xranks, True, cuda)
    res = cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk, precision)
    dys = torch.randn(t, b, h, device=cuda)
    args = (layers, h0s, c0s, mk, *res, dys, [None] * n, [None] * n, precision)
    cuda_stack.lstm_stack_bwd(*args)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_stack.lstm_stack_bwd(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    routed = [cuda_scan.tc_route(*p[:3]) for layer in cuda_stack.stack_tc_products(
        t, b, h, ranks, xranks) for _, p in layer]
    assert len(routed) == 6
    assert sum(routed) == {1: 0, 20: 3, 128: 6}[b]
    assert sum("wg_gemm_kernel" in k for k in names) == sum(routed), names
    assert sum("tc_gemm_kernel" in k for k in names) == len(routed) - sum(routed), names
    assert sum("mul_kernel" in k for k in names) == 1, names
    assert not [k for k in names if "vmlmf::gemm_kernel" in k or "group_partial_kernel" in k]
    assert sum("stack_bwd_kernel" in k for k in names) == 1


def leaves(tree):
    """The tensors of a nested list/tuple/dict, in order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in leaves(v)]
    return [tree]


@pytest.mark.cuda
def test_stack_kernels_refuse_what_they_do_not_take(cuda):
    from vmlmf_tpu_torch.ops import cuda_stack

    gi0, layers, h0s, c0s, mk = stack_inputs(*STACK_CASES["l2_three_blocks"], cuda)
    bad = dict(layers[1], vx=layers[1]["vx"].bfloat16())
    with pytest.raises(TypeError, match="float32"):
        cuda_stack.lstm_stack_scan_fused(gi0, [layers[0], bad], h0s, c0s, mk)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_stack.lstm_stack_scan_fused_res(gi0.transpose(0, 1).contiguous().transpose(0, 1),
                                             layers, h0s, c0s, mk)
    with pytest.raises(ValueError, match="shape"):
        cuda_stack.lstm_stack_scan_fused(gi0[:, :, :-4].contiguous(), layers, h0s, c0s, mk)
    deep = [layers[0]] + [layers[1]] * cuda_stack.MAX_LAYERS
    with pytest.raises(ValueError, match="stack_groups"):
        cuda_stack.lstm_stack_scan_fused(gi0, deep, h0s * 9, c0s * 9, None)
    # 59 MB of factors have no plan even for one row (a batch over one
    # plan's staging runs in chunks of rows instead: lm_b300_chunks)
    wide = stack_inputs(2, 2, 4, 1400, (700, 700), (700,), False, cuda)
    with pytest.raises(ValueError, match="stack_groups"):
        cuda_stack.lstm_stack_scan_fused(*wide[:4], None)
    layers[0]["u"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="LSTMStackScan"):
        cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s, mk)


@pytest.mark.cuda
def test_wavefront_lm_launches_the_stack_kernels_only(cuda, monkeypatch):
    from vmlmf_tpu_torch.ops import cuda_stack
    from vmlmf_tpu_torch.train.lm import LMTrainer

    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    entries = (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
               cuda_scan.lstm_scan_xin_bwd, cuda_stack.lstm_stack_scan_fused,
               cuda_stack.lstm_stack_scan_fused_res, cuda_stack.lstm_stack_bwd)

    def counts():
        return [fn.launches for fn in entries]

    kw = dict(vocab_size=64, hidden_size=40, num_layers=2, dropout_rate=0.5, winit=0.3,
              cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=7, u_rank=9))
    model, fused = LMModel(backend="fused_pipelined", **kw), LMModel(backend="fused", **kw)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    prompt = torch.randint(0, 64, (9, 5), generator=torch.Generator().manual_seed(1)).to(cuda)
    before = counts()
    lw, sw = Decoder(model).prefill(params, prompt, model.state0(5, cuda))
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, 0, 1, 0, 0]
    lf, sf = Decoder(fused).prefill(params, prompt, fused.state0(5, cuda))
    torch.testing.assert_close(lw, lf, **TOL)
    for a, b in zip(leaves(sw), leaves(sf)):
        torch.testing.assert_close(a, b, **TOL)

    trainer = LMTrainer(model, batch_size=5, seq_length=9, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    before = counts()
    _, _, loss, gnorm = trainer.train_step(trainer.init(), trainer.state0(), prompt, prompt, 1.0,
                                           gen)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, 0, 0, 1, 1]
    assert bool(torch.isfinite(loss)) and float(gnorm) > 0


@pytest.mark.cuda
def test_wavefront_reverse_runs_the_per_layer_kernels(cuda, monkeypatch):
    from vmlmf_tpu_torch.nn.recurrence import RNN
    from vmlmf_tpu_torch.ops import cuda_stack

    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    cells = (VMLMFCell(12, 40, w_rank=7, u_rank=9), VMLMFCell(40, 40, w_rank=7, u_rank=9))
    rnn, fused = RNN(cells, backend="fused_pipelined"), RNN(cells, backend="fused")
    params = rnn.init(torch.Generator().manual_seed(0), device=cuda)
    xs = torch.randn(5, 9, 12, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = (cuda_scan.lstm_scan_fused_xin.launches, cuda_stack.lstm_stack_scan_fused.launches)
    with torch.no_grad():
        ys, _ = rnn(params, xs, reverse=True)
        ys_f, _ = fused(params, xs, reverse=True)
    assert (cuda_scan.lstm_scan_fused_xin.launches - before[0],
            cuda_stack.lstm_stack_scan_fused.launches - before[1]) == (4, 0)
    torch.testing.assert_close(ys, ys_f, atol=0.0, rtol=0.0)


# -- the scan's variants: bf16 products, bf16 residuals, recompute, gi mode ----

# bf16 products sum bf16-rounded operands in f32: the kernel and its plain
# version round the same values, but sums in another order can move a value
# across a bf16 rounding boundary (tests/test_pallas.py:97, :114)
BF16_TOL = dict(atol=5e-3, rtol=5e-3)
BF16_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)
RES_GRAD_TOL = dict(atol=2e-2, rtol=2e-2)  # bf16 gates and hu (tests/test_pallas.py:209-213)

# (T, B, F, h, rx, r): each form, the HAR and the PTB LM layer, ragged B, h
# and r, T = 1 and 2
VARIANT_CASES = {
    "f_eq_h": (5, 3, 16, 16, 4, 4), "har": (24, 81, 77, 180, 8, 6),
    "dense_rec_f_gt_h": (7, 9, 70, 33, 5, 0), "dense_x_f_lt_h": (5, 3, 13, 20, 0, 7),
    "dense_har": (24, 81, 77, 180, 0, 0), "lm_b20": (35, 20, 650, 650, 300, 300),
    "dense_lm": (35, 20, 650, 650, 0, 0), "b257_r1": (3, 257, 16, 650, 5, 1),
    "t1": (1, 5, 70, 33, 5, 40), "t2_dense_rec": (2, 3, 16, 650, 8, 0),
}
# (precision, residuals, save_gates)
VARIANTS = {"bf16": ("bf16", "f32", True), "bf16_res": ("f32", "bf16", True),
            "recompute": ("f32", "f32", False), "bf16+bf16_res": ("bf16", "bf16", True),
            "bf16+recompute": ("bf16", "f32", False)}


def variant_tols(precision, residuals):
    if precision == "bf16":
        return BF16_TOL, BF16_TOL, BF16_GRAD_TOL
    if residuals == "bf16":
        return TOL, BF16_TOL, RES_GRAD_TOL
    return TOL, TOL, GRAD_TOL


def rms_diff(pairs):
    pairs = list(pairs)
    sq = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in pairs)
    return (sq / sum(a.numel() for a, _ in pairs)) ** 0.5


def assert_bf16_not_f32(name, gots, bf16_plain, f32_plain):
    """A bf16 kernel's results lie 4 times nearer (in root mean square) its
    plain bf16 version than that version lies to the plain f32 one; a
    kernel that ignored the bf16 flag would sit at the gap, inside the bf16
    tolerances. Sums in another order move a value across a bf16 rounding
    boundary now and then, and a crossing spreads along the scan, so the
    control reads the first two steps of a walk: every path of the kernel
    has run there, and no crossing has spread yet."""
    err, gap = rms_diff(zip(gots, bf16_plain)), rms_diff(zip(bf16_plain, f32_plain))
    assert err * 4 < gap, f"{name}: rms {err:.3g} to bf16 plain, bf16-f32 gap {gap:.3g}"


def assert_pairs_close(names, gots, wants, tol):
    for name, got, want in zip(names, gots, wants):
        assert (got is None) == (want is None), name
        if want is not None:
            assert got.dtype == want.dtype, name
            torch.testing.assert_close(got.float(), want.float(), msg=name, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", list(VARIANT_CASES))
def test_variant_kernels_match_plain(cuda, case, variant):
    precision, residuals, save = VARIANTS[variant]
    t, b, f, h, rx, r = VARIANT_CASES[case]
    args = make_inputs(t, b, f, h, rx, r, cuda)
    # cotangents scaled so that the gradients are O(1), where the absolute
    # part of the bf16 tolerance means what it says
    rng = np.random.default_rng(1)
    dys = torch.from_numpy(0.1 * rng.standard_normal((t, b, h)).astype(np.float32)).to(cuda)
    dc_last = torch.from_numpy(0.1 * rng.standard_normal((b, h)).astype(np.float32)).to(cuda)
    fns = (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
           cuda_scan.lstm_scan_xin_bwd)
    names = (precision, variant, variant)
    before = [fn.variants[n] for fn, n in zip(fns, names)]
    bias = None if save else args[4]
    fwd = cuda_scan.lstm_scan_fused_xin(*args, precision)
    res = cuda_scan.lstm_scan_fused_xin_res(*args, precision, residuals, save)
    grads = cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, dc_last, bias=bias,
                                        precision=precision)
    torch.cuda.synchronize()
    assert [fn.variants[n] - c for fn, n, c in zip(fns, names, before)] == [1, 1, 1]
    fwd_tol, res_tol, grad_tol = variant_tols(precision, residuals)
    assert_pairs_close(("ys", "c_last"), fwd,
                       cuda_scan.lstm_scan_fused_xin_plain(*args, precision), fwd_tol)
    res_p = cuda_scan.lstm_scan_xin_fwd_res_plain(*args, precision, residuals, save)
    assert_pairs_close(("ys", "cs", "gates", "hu", "xu"), res, res_p, res_tol)
    grads_p = cuda_scan.lstm_scan_xin_bwd_plain(*args[:4], *args[5:], *res_p, dys, dc_last,
                                                bias=bias, precision=precision)
    assert_pairs_close(cuda_scan._ARG_NAMES, grads, grads_p, grad_tol)
    if precision == "bf16":
        # the BPTTs from the kernel's own residuals: the backward's rounding alone
        f32 = cuda_scan.lstm_scan_xin_fwd_res_plain(*args, "f32", residuals, save)
        assert_bf16_not_f32("ys[:2]", [fwd[0][:2]], [res_p[0][:2]], [f32[0][:2]])
        assert_bf16_not_f32("ys, cs [:2]", [a[:2] for a in res[:2]], [a[:2] for a in res_p[:2]],
                            [a[:2] for a in f32[:2]])
        dxs = [cuda_scan.lstm_scan_xin_bwd_plain(*args[:4], *args[5:], *res, dys, dc_last,
                                                 bias=bias, precision=p)[0][-2:]
               for p in ("bf16", "f32")]
        assert_bf16_not_f32("dxs[-2:]", [grads[0][-2:]], *[[d] for d in dxs])


# (T, B, h, r), r = 0 a dense recurrent side
GI_CASES = {"f_eq_h": (5, 3, 16, 4), "lm_b20": (35, 20, 650, 300), "dense_lm": (35, 20, 650, 0),
            "b257_r1": (3, 257, 650, 1), "t1": (1, 5, 33, 40), "t2_dense": (2, 3, 650, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision,residuals", [("f32", "f32"), ("bf16", "f32"),
                                                 ("f32", "bf16"), ("bf16", "bf16")])
@pytest.mark.parametrize("case", list(GI_CASES))
def test_gi_mode_kernels_match_plain(cuda, case, precision, residuals):
    t, b, h, r = GI_CASES[case]
    rng = np.random.default_rng(2)

    def n(*shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(cuda)

    args = (n(t, b, 4 * h, scale=1.0), n(h, r or 4 * h, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5) if r else None, n(4 * h, scale=0.1), n(b, h, scale=0.5),
            n(b, h, scale=0.5))
    dys, dc_last = n(t, b, h, scale=1.0), n(b, h, scale=1.0)
    fns = (cuda_scan.lstm_scan_fused, cuda_scan.lstm_scan_fused_res, cuda_scan.lstm_scan_bwd)
    before = [fn.launches for fn in fns]
    fwd = cuda_scan.lstm_scan_fused(*args, precision)
    res = cuda_scan.lstm_scan_fused_res(*args, precision, residuals)
    grads = cuda_scan.lstm_scan_bwd(*args[1:], *res, dys, dc_last, precision)
    torch.cuda.synchronize()
    assert [fn.launches - c for fn, c in zip(fns, before)] == [1, 1, 1]
    fwd_tol, res_tol, grad_tol = variant_tols(precision, residuals)
    assert_pairs_close(("ys", "c_last"), fwd, cuda_scan.lstm_scan_fused_plain(*args, precision),
                       fwd_tol)
    res_p = cuda_scan.lstm_recurrence_plain(*args, precision, residuals)
    assert_pairs_close(("ys", "cs", "gates", "hu"), res, res_p, res_tol)
    grads_p = cuda_scan.lstm_scan_bwd_plain(*args[1:], *res_p, dys, dc_last, precision)
    assert_pairs_close(("dgi", "du", "dv", "ddvec", "dh0", "dc0"), grads, grads_p, grad_tol)
    if precision == "bf16":
        f32 = cuda_scan.lstm_recurrence_plain(*args, "f32", residuals)
        assert_bf16_not_f32("ys[:2]", [fwd[0][:2]], [res_p[0][:2]], [f32[0][:2]])
        assert_bf16_not_f32("ys, cs [:2]", [a[:2] for a in res[:2]], [a[:2] for a in res_p[:2]],
                            [a[:2] for a in f32[:2]])
        if t > 1:  # at T = 1 no product feeds dgi
            dgi = [cuda_scan.lstm_scan_bwd_plain(*args[1:], *res, dys, dc_last, p)[0][-2:]
                   for p in ("bf16", "f32")]
            assert_bf16_not_f32("dgi[-2:]", [grads[0][-2:]], *[[d] for d in dgi])


@pytest.mark.cuda
def test_variant_kernels_are_deterministic_and_refuse_what_they_do_not_take(cuda):
    args = make_inputs(24, 81, 77, 180, 8, 6, cuda)
    runs = [cuda_scan.lstm_scan_fused_xin_res(*args, "bf16", "bf16") for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    res = runs[0]
    with pytest.raises(TypeError, match="bfloat16"):  # hu must match the gates' type
        cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res[:3], res[3].float(), res[4],
                                    None, None)
    res = cuda_scan.lstm_scan_fused_xin_res(*args, save_gates=False)
    with pytest.raises(ValueError, match="recompute"):  # recompute needs the bias
        cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, None, None)
    with pytest.raises(ValueError, match="precision"):
        cuda_scan.lstm_scan_fused_xin(*args, "fp16")


@pytest.mark.cuda
@pytest.mark.parametrize("switches,entries", [
    ({"VMLMF_PALLAS_PRECISION": "bf16"}, ("lstm_scan_fused_xin_res", "lstm_scan_xin_bwd")),
    ({"VMLMF_PALLAS_XIN": "0"}, ("lstm_scan_fused_res", "lstm_scan_bwd")),
    ({"VMLMF_PALLAS_SAVED_GATES": "0", "VMLMF_PALLAS_RESIDUALS": "bf16"},
     ("lstm_scan_fused_xin_res", "lstm_scan_xin_bwd"))], ids=["bf16", "gi", "recompute"])
def test_train_step_routes_each_switch_to_its_kernels(cuda, monkeypatch, switches, entries):
    from vmlmf_tpu_torch.train.lm import LMTrainer

    for k, v in switches.items():
        monkeypatch.setenv(k, v)
    kw = dict(vocab_size=64, hidden_size=40, num_layers=2, dropout_rate=0.0, winit=0.3,
              cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=7, u_rank=9))
    model = LMModel(head_bf16=True, **kw)
    trainer = LMTrainer(model, batch_size=5, seq_length=9, device=cuda)
    ids = torch.randint(0, 64, (9, 5), generator=torch.Generator().manual_seed(1)).to(cuda)
    fns = [getattr(cuda_scan, e) for e in entries]
    before = [fn.launches for fn in fns]
    variant = cuda_scan.variant(switches.get("VMLMF_PALLAS_PRECISION", "f32"),
                                switches.get("VMLMF_PALLAS_RESIDUALS", "f32"),
                                switches.get("VMLMF_PALLAS_SAVED_GATES") != "0")
    named = [fn.variants[variant] for fn in fns]
    _, _, loss, gnorm = trainer.train_step(trainer.init(), trainer.state0(), ids, ids, 1.0)
    torch.cuda.synchronize()
    assert [fn.launches - c for fn, c in zip(fns, before)] == [2, 2]
    assert [fn.variants[variant] - c for fn, c in zip(fns, named)] == [2, 2]
    assert bool(torch.isfinite(loss)) and float(gnorm) > 0


@pytest.mark.cuda
def test_bf16_head_product_matches_its_cpu_function(cuda):
    from vmlmf_tpu_torch.nn.layers import Bf16Product

    rng = np.random.default_rng(3)
    x, w, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((35, 20, 650), (650, 1000), (35, 20, 1000)))
    outs = []
    for dev in ("cpu", cuda):
        xt, wt = (a.to(dev).requires_grad_() for a in (x, w))
        y = Bf16Product.apply(xt, wt)
        outs.append([y.detach().cpu(), *(d.cpu() for d in torch.autograd.grad(y, (xt, wt),
                                                                                g.to(dev)))])
    # the product sums exact bf16 products in f32; its gradients are rounded
    # to bf16, where a sum in another order can flip the last bit
    torch.testing.assert_close(outs[1][0], outs[0][0], **BF16_TOL)
    for got, want in zip(outs[1][1:], outs[0][1:]):
        torch.testing.assert_close(got, want, **BF16_GRAD_TOL)


# fault 9: the PTB VMLMF LM layer at B=1024, past the largest batch one
# launch's plan takes (656), runs in chunks of rows, one launch each, the
# BPTT's weight gradients summed over the chunks in order
@pytest.mark.cuda
def test_lm_layer_past_one_plan_runs_in_chunks_and_matches_plain(cuda):
    t, b, f, h, rx, r = 35, 1024, 650, 650, 300, 300
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunks = cuda_scan.scan_chunks(b, h, r, sms)
    assert len(chunks) > 1 and sum(n for _, n, _ in chunks) == b
    args = make_inputs(t, b, f, h, rx, r, cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    fns = (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
           cuda_scan.lstm_scan_xin_bwd)
    counts = [fn.launches for fn in fns]
    ys, c_last = cuda_scan.lstm_scan_fused_xin(*args)
    res, grads = residual_and_grads(args, dys, None, cuda_scan.lstm_scan_fused_xin_res,
                                    cuda_scan.lstm_scan_xin_bwd)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fns] == [n + len(chunks) for n in counts]
    want = cuda_scan.lstm_scan_fused_xin_plain(*args)
    torch.testing.assert_close(ys, want[0], **TOL)
    torch.testing.assert_close(c_last, want[1], **TOL)
    res_p, grads_p = residual_and_grads(args, dys, None, cuda_scan.lstm_scan_xin_fwd_res_plain,
                                        cuda_scan.lstm_scan_xin_bwd_plain)
    for name, got, w in zip(("ys", "cs", "gates", "hu", "xu"), res, res_p):
        torch.testing.assert_close(got, w, msg=name, **TOL)
    for name, got, w in zip(cuda_scan._ARG_NAMES, grads, grads_p):
        torch.testing.assert_close(got, w, msg=name, **GRAD_TOL)


# fault 10: a dense "pre" GRU layer at h=1000 and B=512, whose four rows a
# CTA do not fit in shared memory, runs with fewer rows a CTA
@pytest.mark.cuda
def test_gru_layer_with_fewer_rows_a_cta_matches_plain(cuda, monkeypatch):
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = 24, 512, 77, 1000, 0, 0, "pre", False
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = cuda_gru.gru_plan(t, b, f, rx, h, r, cuda_gru.DENSE_PRE, sms=sms)
    assert plan.rows < min(cuda_gru.GRU_MAX_ROWS, -(-b // sms)) and plan.ctas > sms
    monkeypatch.setattr(cuda_gru, "_plan_for", lambda *a, gi=False: plan)  # the row kernels
    args = gru_inputs(t, b, f, h, rx, r, mode, lowrank, cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    ys = cuda_gru.gru_scan_fused_xin(*args, mode=mode)
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    saved = (*args[:3], *args[4:], *res)
    grads = cuda_gru.gru_scan_xin_bwd(*saved, dys, mode=mode)
    torch.cuda.synchronize()
    res_p = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode)
    torch.testing.assert_close(ys, res_p[0], **TOL)
    for name, got, want in zip(("ys", "gates", "hu", "rhu", "recn", "xu"), res, res_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **TOL)
    grads_p = cuda_gru.gru_scan_xin_bwd_plain(*saved[:13], dys, mode=mode)
    for name, got, want in zip(("dxs", "dux", "dvx", "dbias", "duf", "dprz", "dpn", "dh0"),
                               grads, grads_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **GRAD_TOL)


def bench_ranker(backend, items=10_000):
    """The ranker's bench width (H=650, one VMLMF layer w300/u300) over a
    smaller catalog."""
    from vmlmf_tpu_torch.serve.ranker import SessionRanker

    return SessionRanker.create(items, hidden_size=650, num_layers=1, w_rank=300, u_rank=300,
                                backend=backend)


@pytest.mark.cuda
def test_ranker_rank_next_fused_matches_loop(cuda):
    fused, loop = bench_ranker("fused"), bench_ranker("loop")
    params = fused.init(torch.Generator().manual_seed(0), device=cuda)
    sess = torch.randint(0, fused.num_items, (35, 32),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    before = cuda_scan.lstm_scan_fused_xin.launches
    with torch.no_grad():
        vals, top = fused.rank_next(params, sess, 100, exclude_seen=True)
        want_v, want_i = loop.rank_next(params, sess, 100, exclude_seen=True)
        h, _ = loop.encode(params, sess)
        plain = loop._mask_seen(loop.score(params, h), sess, offset=0)
    torch.cuda.synchronize()
    assert cuda_scan.lstm_scan_fused_xin.launches == before + 1
    assert top.dtype == torch.int32 and top.shape == want_i.shape
    torch.testing.assert_close(vals, want_v, **TOL)
    # the ranks are equal but where the plain path's scores tie within twice
    # the tolerance: the scan's f32 products (3xTF32) and cuBLAS's sum in
    # another order, so two items so near may trade places, or one just
    # outside the top k take the last place. There the item the kernel puts
    # at place j must score the plain path's j-th best within that margin.
    ranked = torch.topk(plain, top.shape[1] + 1, dim=1).values
    margin = 2 * (TOL["atol"] + TOL["rtol"] * ranked[:, 1:].abs())
    near = ranked[:, :-1] - ranked[:, 1:] <= margin  # place j against j + 1
    tied = near.clone()
    tied[:, 1:] |= near[:, :-1]
    moved = [(i, j, int(top[i, j]), int(want_i[i, j]), float(plain[i, top[i, j]]),
              float(plain[i, want_i[i, j]]))
             for i, j in (top.long() != want_i.long()).nonzero().tolist()]
    print(f"places whose items differ (session, place, the kernel's item, the plain path's, "
          f"their plain scores): {moved}")
    assert torch.equal(top.long()[~tied], want_i.long()[~tied])
    torch.testing.assert_close(plain.gather(1, top.long()), want_v,
                               atol=2 * TOL["atol"], rtol=2 * TOL["rtol"])


@pytest.mark.cuda
def test_ranker_sparse_step_with_kernels_matches_plain_path(cuda):
    """One sparse sampled-softmax step on "fused" (the residual forward and the
    BPTT kernels) against "loop", from the same parameters and negatives;
    and two equal "fused" steps to equal bits."""
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 10_000, (35, 32), generator=g).to(cuda)
    y = torch.randint(0, 10_000, (35, 32), generator=g).to(cuda)
    neg = torch.randint(0, 10_000, (1024,), generator=g).to(cuda)
    outs = []
    for backend in ("fused", "fused", "loop"):
        t = bench_ranker(backend).sparse_trainer(batch_size=32, seq_length=35,
                                                 sampled_softmax=1024, device=cuda)
        p, _, loss, gnorm = t.train_step(t.init(), t.state0(), x, y, 0.1, negatives=neg)
        outs.append([loss, gnorm] + tree_leaves(p))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    for a, b in zip(outs[0], outs[2]):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_world1_nccl_lm_step_bit_equal_to_no_mesh(cuda):
    import socket

    import torch.distributed as dist

    from vmlmf_tpu_torch.parallel import mesh as pmesh
    from vmlmf_tpu_torch.train.lm import LMTrainer
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pmesh.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device_type="cuda", timeout=60)
    try:
        mesh = pmesh.make_mesh(1, 1)
        model = LMModel(vocab_size=1000, hidden_size=650, num_layers=2, dropout_rate=0.5,
                        cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=300, u_rank=300))
        g = torch.Generator().manual_seed(3)
        x, y = (torch.randint(0, 1000, (35, 20), generator=g) for _ in range(2))
        outs = []
        for m in (None, mesh):
            t = LMTrainer(model, batch_size=20, seq_length=35, mesh=m)
            gen = torch.Generator(device=cuda).manual_seed(4)
            p, st, loss, gnorm = t.train_step(t.init(), t.state0(), x, y, 1.0, gen)
            outs.append([loss, gnorm] + tree_leaves(p) + tree_leaves(st))
        assert all(torch.equal(a, b) for a, b in zip(*outs))
    finally:
        dist.destroy_process_group()


# -- captured steps (utils/graphs.py): each graphed path against its eager
# step loop from equal seeds and generators, bit for bit


def _equal(a, b):
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    return all(torch.equal(x.detach(), y.detach()) for x, y in zip(tree_leaves(a),
                                                                   tree_leaves(b)))


@pytest.mark.cuda
def test_captured_cooperative_launch_replays(cuda):
    """The no-grad LSTM scan (a cooperative launch over all SMs, barrier words
    zeroed by a memset node) captured once and replayed on new inputs."""
    from vmlmf_tpu_torch.utils.graphs import StepGraph

    args = make_inputs(35, 20, 650, 650, 300, 300, cuda)
    graph = StepGraph(cuda_scan.lstm_scan_fused_xin, args, device=cuda)
    for trial in range(5):  # two eager warm-up steps, the capture, two replays
        inputs = make_inputs(35, 20, 650, 650, 300, 300, cuda, seed=trial)
        before = cuda_scan.lstm_scan_fused_xin.launches
        got = [o.clone() for o in graph(*inputs)]
        assert cuda_scan.lstm_scan_fused_xin.launches == before + 1  # a replay counts its one
        want = cuda_scan.lstm_scan_fused_xin(*inputs)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), trial
    assert graph.captured


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "fused_pipelined"])
def test_graphed_lm_train_steps_equal_eager(cuda, backend, monkeypatch):
    from vmlmf_tpu_torch.ops import cuda_stack
    from vmlmf_tpu_torch.train.lm import LMTrainer

    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    model = LMModel(vocab_size=500, hidden_size=128, num_layers=2, dropout_rate=0.5, winit=0.1,
                    backend=backend, cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=32,
                                                                         u_rank=24))
    trainer = LMTrainer(model, batch_size=20, seq_length=35, device=cuda)
    g = torch.Generator().manual_seed(5)
    xs, ys = (torch.randint(0, 500, (6, 35, 20), generator=g).to(cuda) for _ in range(2))
    runs = []
    for graphed in (True, False):
        params, states = trainer.init(), trainer.state0()
        gen = torch.Generator(device=cuda).manual_seed(6)
        if graphed:
            for lr in (0.7, 0.5):  # the second call replays only
                params, states, losses, gnorms = trainer._fused_chunks(params, states, xs, ys,
                                                                       lr, gen)
        else:
            out = []
            for lr in (0.7, 0.5):
                for x, y in zip(xs, ys):
                    params, states, loss, gnorm = trainer.train_step(params, states, x, y, lr,
                                                                     gen)
                    out.append((loss, gnorm))
            losses, gnorms = (torch.stack([o[i] for o in out[6:]]) for i in (0, 1))
        runs.append((params, states, losses, gnorms))
    assert _equal(runs[0], runs[1]) and trainer._graphs["train"][1].graph.captured
    wavefront = backend == "fused_pipelined"
    entry = cuda_stack.lstm_stack_bwd if wavefront else cuda_scan.lstm_scan_xin_bwd
    before = entry.launches
    trainer._fused_chunks(*runs[0][:2], xs, ys, 0.5, gen)  # the graphed run's: replays only
    assert entry.launches - before == len(xs) * (1 if wavefront else 2)


def _har_models():
    from vmlmf_tpu_torch.nn.models import HARNet

    yield "vmlmf", HARNet(77, (180,), num_classes=18, cell_factory=lambda n, h: VMLMFCell(
        n, h, w_rank=8, u_rank=6))
    yield "gru", gru_har("fused", group=False)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["vmlmf", "gru"])
def test_graphed_har_steps_equal_eager(cuda, which):
    from vmlmf_tpu_torch.train.har import HARTrainer

    model = dict(_har_models())[which]
    trainer = HARTrainer(model, batch_size=81, device=cuda)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((5, 81, 24, 77)).astype(np.float32)).to(cuda)
    ys = torch.from_numpy(rng.integers(0, 18, (5, 81))).to(cuda)
    (pa, oa), (pb, ob) = trainer.init(), trainer.init()
    assert oa.defaults["capturable"]
    pa, oa, la = trainer._fused_steps(pa, oa, xs, ys)
    lb = []
    for x, y in zip(xs, ys):
        pb, ob, loss = trainer.train_step(pb, ob, x, y)
        lb.append(loss)
    assert torch.equal(la, torch.stack(lb)) and _equal(pa, pb)
    assert _equal([s for st in oa.state.values() for s in st.values()],
                  [s for st in ob.state.values() for s in st.values()])


@pytest.mark.cuda
def test_graphed_ranker_sparse_chunks_equal_eager(cuda):
    g = torch.Generator().manual_seed(2)
    xs = torch.randint(0, 10_000, (4, 35, 32), generator=g).to(cuda)
    ys = torch.randint(0, 10_000, (4, 35, 32), generator=g).to(cuda)
    t = bench_ranker("fused").sparse_trainer(batch_size=32, seq_length=35, sampled_softmax=1024,
                                             device=cuda)
    runs = []
    for graphed in (True, False):
        p, s = t.init(), t.state0()
        gen = torch.Generator(device=cuda).manual_seed(3)
        if graphed:
            p, s, losses, gnorms = t.fused_chunks(p, s, xs, ys, 0.1, gen)
        else:
            out = []
            for x, y in zip(xs, ys):
                p, s, loss, gnorm = t.train_step(p, s, x, y, 0.1, gen)
                out.append((loss, gnorm))
            losses, gnorms = (torch.stack([o[i] for o in out]) for i in (0, 1))
        runs.append((p, s, losses, gnorms))
    assert _equal(runs[0], runs[1]) and t._graph[1].graph.captured


def _served(cuda):
    model = LMModel(vocab_size=2000, hidden_size=128, num_layers=2, dropout_rate=0.0, winit=0.5,
                    cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=32, u_rank=24))
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    prompt = torch.randint(0, 2000, (12, 8), generator=torch.Generator().manual_seed(1)).to(cuda)
    return model, params, prompt


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "top_k", "beam"])
def test_graphed_decode_equals_eager(cuda, mode, monkeypatch):
    from vmlmf_tpu_torch.serve import decoder

    model, params, prompt = _served(cuda)

    def run(dec):
        if mode == "beam":
            return dec.beam_search(params, prompt, steps=10, beams=4)
        logits, states = dec.prefill(params, prompt, model.state0(8, cuda))
        kw = {} if mode == "greedy" else dict(
            temperature=0.9, top_k=20, generator=torch.Generator(device=cuda).manual_seed(7))
        return dec.decode(params, logits, states, steps=12, return_logits=True, **kw)

    graphed = run(Decoder(model))
    with monkeypatch.context() as mp:
        mp.setattr(decoder, "on_card", lambda device: False)  # the same step, eager
        eager = run(Decoder(model))
    assert _equal(graphed, eager)


@pytest.mark.cuda
def test_decode_graph_is_cached_and_captured_again_for_new_parameters(cuda):
    model, params, prompt = _served(cuda)
    dec = Decoder(model)
    logits, states = dec.prefill(params, prompt, model.state0(8, cuda))
    first = dec.decode(params, logits, states, steps=6)
    (step,) = dec._graphs.values()
    second = dec.decode(params, logits, states, steps=6)
    assert _equal(first, second) and list(dec._graphs.values()) == [step]
    other = {k: v for k, v in params.items()}
    other["fc"] = {k: v.clone() for k, v in params["fc"].items()}  # new tensors, same values
    third = dec.decode(other, logits, states, steps=6)
    assert _equal(first, third) and len(dec._graphs) == 2
    # sampling: a new generator a call is a value of the call, not a new graph
    sampled = [dec.decode(params, logits, states, steps=6, temperature=0.9, top_k=20,
                          generator=torch.Generator(device=cuda).manual_seed(3))
               for _ in range(2)]
    assert _equal(*sampled) and len(dec._graphs) == 3


@pytest.mark.cuda
def test_launch_counters_stay_right_across_replays(cuda):
    from vmlmf_tpu_torch.train.lm import LMTrainer

    model, x, y = lm_and_batch(cuda, "fused")
    trainer = LMTrainer(model, batch_size=5, seq_length=9, device=cuda)
    params, states = trainer.init(), trainer.state0()
    xs, ys = x[None].expand(7, -1, -1), y[None].expand(7, -1, -1)
    before = (cuda_scan.lstm_scan_fused_xin_res.launches, cuda_scan.lstm_scan_xin_bwd.launches)
    trainer._fused_chunks(params, states, xs, ys, 0.5)
    torch.cuda.synchronize()
    after = (cuda_scan.lstm_scan_fused_xin_res.launches, cuda_scan.lstm_scan_xin_bwd.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (2 * 7, 2 * 7)  # 2 layers a step


@pytest.mark.cuda
def test_graphed_lm_fit_equals_fit_stepping(cuda):
    """`fit` in blocks of 3 chunks over 7 (the seventh an eager step between
    two blocks' replays, from the generator the graph draws from), with the
    eval graph for perplexity, against `fit` chunk by chunk."""
    from vmlmf_tpu_torch.data.ptb import minibatch, synthetic_corpus
    from vmlmf_tpu_torch.train.lm import LMTrainer

    model = LMModel(vocab_size=200, hidden_size=64, num_layers=2, dropout_rate=0.5, winit=0.1,
                    cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=16, u_rank=12))
    b, t = 8, 10
    corpus = synthetic_corpus(vocab_size=200, length=b * (t * 11 + 4), seed=0)
    cut = b * (t * 7 + 2)
    data = (minibatch(corpus[:cut], b, t), minibatch(corpus[cut:], b, t),
            minibatch(corpus[cut:], b, t))
    assert len(data[0]) == 7
    out = []
    for fuse in (3, 1):
        trainer = LMTrainer(model, batch_size=b, seq_length=t, fuse_chunks=fuse, device=cuda)
        params, hist = trainer.fit(trainer.init(), data, epochs=2, log_fn=None)
        out.append((params, hist))
    assert out[0][1] == out[1][1] and _equal(out[0][0], out[1][0])


# -- the last eager paths as graphs: the trainers' blocks on a 1x1 NCCL mesh,
# their collectives captured, and the graphed prefill


@pytest.fixture
def nccl_mesh(cuda):
    """A 1x1 mesh over NCCL at world size 1; the group is destroyed after
    the test's graphs are freed."""
    import gc
    import socket

    import torch.distributed as dist

    from vmlmf_tpu_torch.parallel import mesh as pmesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pmesh.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device_type="cuda", timeout=60)
    try:
        yield pmesh.make_mesh(1, 1)
    finally:
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_graphed_lm_block_on_a_1x1_nccl_mesh_equals_eager(cuda, nccl_mesh):
    """`_fused_chunks` on the mesh (its gradient and loss sums captured)
    against its eager steps on the mesh and against the graph without a
    mesh, bit for bit, with equal launch counts."""
    from vmlmf_tpu_torch.train.lm import LMTrainer

    model = LMModel(vocab_size=500, hidden_size=128, num_layers=2, dropout_rate=0.5, winit=0.1,
                    cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=32, u_rank=24))
    g = torch.Generator().manual_seed(5)
    xs, ys = (torch.randint(0, 500, (6, 35, 20), generator=g) for _ in range(2))
    runs, launches = [], []
    for mesh, graphed in ((nccl_mesh, True), (nccl_mesh, False), (None, True)):
        trainer = LMTrainer(model, batch_size=20, seq_length=35, device=cuda, mesh=mesh)
        sx, sy = trainer.commit_batch(xs, ys, stacked=True)
        params, states = trainer.init(), trainer.state0()
        gen = torch.Generator(device=cuda).manual_seed(6)
        before = cuda_scan.lstm_scan_xin_bwd.launches
        if graphed:
            params, states, losses, gnorms = trainer._fused_chunks(params, states, sx, sy, 0.7,
                                                                   gen)
            assert trainer._graphs["train"][1].graph.captured
        else:
            out = []
            for x, y in zip(sx, sy):
                params, states, loss, gnorm = trainer.train_step(params, states, x, y, 0.7, gen)
                out.append((loss, gnorm))
            losses, gnorms = (torch.stack([o[i] for o in out]) for i in (0, 1))
        torch.cuda.synchronize()
        launches.append(cuda_scan.lstm_scan_xin_bwd.launches - before)
        runs.append((params, states, losses, gnorms))
    assert _equal(runs[0], runs[1]) and _equal(runs[0], runs[2])
    assert launches == [2 * 6] * 3


@pytest.mark.cuda
def test_graphed_har_block_on_a_1x1_nccl_mesh_equals_eager(cuda, nccl_mesh):
    from vmlmf_tpu_torch.train.har import HARTrainer

    model = dict(_har_models())["vmlmf"]
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((5, 81, 24, 77)).astype(np.float32)
    ys = rng.integers(0, 18, (5, 81))
    runs = []
    for mesh, graphed in ((nccl_mesh, True), (nccl_mesh, False), (None, True)):
        trainer = HARTrainer(model, batch_size=81, device=cuda, mesh=mesh)
        sx, sy = trainer.commit_batch(xs, ys, stacked=True)
        params, opt = trainer.init()
        assert opt.defaults["capturable"]
        if graphed:
            params, opt, losses = trainer._fused_steps(params, opt, sx, sy)
            assert trainer._graph[1].graph.captured
        else:
            losses = []
            for x, y in zip(sx, sy):
                params, opt, loss = trainer.train_step(params, opt, x, y)
                losses.append(loss)
            losses = torch.stack(losses)
        runs.append((params, losses, [s for st in opt.state.values() for s in st.values()]))
    assert _equal(runs[0], runs[1]) and _equal(runs[0], runs[2])


def _prefill_model(backend):
    return LMModel(vocab_size=2000, hidden_size=650, num_layers=2, dropout_rate=0.0, winit=0.05,
                   backend=backend, cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=300,
                                                                        u_rank=300))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 20, 128])
@pytest.mark.parametrize("backend", ["fused", "fused_pipelined"])
def test_graphed_prefill_equals_eager(cuda, backend, b, monkeypatch):
    from vmlmf_tpu_torch.serve import decoder

    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    model = _prefill_model(backend)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    g = torch.Generator().manual_seed(1)
    dec = Decoder(model)
    for trial in range(4):  # two eager warm-up calls, the capture, a replay
        ids = torch.randint(0, 2000, (35, b), generator=g).to(cuda)
        states = [tuple(0.1 * torch.randn(b, 650, generator=g).to(cuda) for _ in range(2))
                  for _ in range(2)]
        got = dec.prefill(params, ids, states)
        with monkeypatch.context() as mp:
            mp.setattr(decoder, "on_card", lambda device: False)
            want = Decoder(model).prefill(params, ids, states)
        assert _equal(got, want), trial
    (step,) = dec._prefills.values()
    assert step.run.captured


@pytest.mark.cuda
def test_prefill_graph_is_reused_for_a_shape_and_captured_for_a_new_one(cuda):
    model, params, prompt = _served(cuda)
    dec = Decoder(model)
    first = [dec.prefill(params, prompt, model.state0(8, cuda)) for _ in range(3)][-1]
    (step,) = dec._prefills.values()
    assert step.run.captured
    other = torch.flip(prompt, (0,))
    again = dec.prefill(params, other, model.state0(8, cuda))  # a replay on a new prompt
    assert list(dec._prefills.values()) == [step]
    assert _equal(again, Decoder(model).prefill(params, other, model.state0(8, cuda)))
    assert not _equal(again, first)
    longer = torch.cat([prompt, other])
    got = dec.prefill(params, longer, model.state0(8, cuda))  # a new shape, a new graph
    assert len(dec._prefills) == 2 and dec._graphs == {}
    del got
    tokens = dec.generate(params, prompt, max_new_tokens=5)  # the first graph again
    assert len(dec._prefills) == 2 and len(dec._graphs) == 1
    assert torch.equal(tokens, dec.decode(params, *first, steps=5)[0])


# fault 11: layers too wide for the shared memory of all SMs. The PTB
# "large" LM's dense layer (h=1500: a 36 MB U) and a low-rank layer of that
# width (r=750) stream the weight rows that do not fit through L2 in f32; in
# bf16 the dense one has a resident plan at B=20 and one streamed launch at
# 128, both on the tensor-core walk (`ScanPlan.mma`)
WIDE_LSTM = {"dense": (35, 1500, 1500, 0, 0), "lowrank": (35, 1500, 1500, 750, 750),
             "dense_1600": (35, 1600, 1600, 0, 0)}
# (case, B, precision): each layer at both batches in f32 and bf16, and a
# dense width whose bf16 plan streams (h=1600 at B=20)
WIDE_LSTM_CALLS = [(case, b, precision) for case in ("dense", "lowrank") for b in (20, 128)
                   for precision in ("f32", "bf16")] + [("dense_1600", 20, "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("case,b,precision", WIDE_LSTM_CALLS)
def test_wide_lstm_layer_entries_match_plain(cuda, case, b, precision):
    t, f, h, rx, r = WIDE_LSTM[case]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunks = cuda_scan.scan_chunks(b, h, r, sms, 2 if precision == "bf16" else 4)
    if precision == "f32" or case == "dense_1600":  # streamed: each kernel on a ring
        assert all(plan.streamed and plan.piece_fwd and plan.piece_bwd for _, _, plan in chunks)
    args = make_inputs(t, b, f, h, rx, r, cuda)
    rng = np.random.default_rng(1)
    # bf16 cotangents at chip_smoke.py's scale: its tolerances hold an
    # absolute error, which grows with the gradients' size
    scale = 0.1 if precision == "bf16" else 1.0
    dys, dc_last = (torch.from_numpy(scale * rng.standard_normal(s).astype(np.float32)).to(cuda)
                    for s in ((t, b, h), (b, h)))
    gi = cuda_scan._gi_plain(*args[:5], h, False)[1].contiguous()
    fns = (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
           cuda_scan.lstm_scan_xin_bwd, cuda_scan.lstm_scan_fused, cuda_scan.lstm_scan_fused_res,
           cuda_scan.lstm_scan_bwd)
    before = [fn.launches for fn in fns]
    fwd = cuda_scan.lstm_scan_fused_xin(*args, precision)
    res = cuda_scan.lstm_scan_fused_xin_res(*args, precision, "f32", True)
    grads = cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, dc_last,
                                        precision=precision)
    gi_fwd = cuda_scan.lstm_scan_fused(gi, *args[5:], precision)
    gi_res = cuda_scan.lstm_scan_fused_res(gi, *args[5:], precision, "f32")
    gi_grads = cuda_scan.lstm_scan_bwd(*args[5:], *gi_res, dys, dc_last, precision)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(fns, before)] == [len(chunks)] * 6
    fwd_tol, res_tol, grad_tol = variant_tols(precision, "f32")
    assert_pairs_close(("ys", "c_last"), fwd,
                       cuda_scan.lstm_scan_fused_xin_plain(*args, precision), fwd_tol)
    res_p = cuda_scan.lstm_scan_xin_fwd_res_plain(*args, precision)
    assert_pairs_close(("ys", "cs", "gates", "hu", "xu"), res, res_p, res_tol)
    grads_p = cuda_scan.lstm_scan_xin_bwd_plain(*args[:4], *args[5:], *res_p, dys, dc_last,
                                                precision=precision)
    assert_pairs_close(cuda_scan._ARG_NAMES, grads, grads_p, grad_tol)
    assert_pairs_close(("ys", "c_last"), gi_fwd,
                       cuda_scan.lstm_scan_fused_plain(gi, *args[5:], precision), fwd_tol)
    gi_res_p = cuda_scan.lstm_recurrence_plain(gi, *args[5:], precision)
    assert_pairs_close(("ys", "cs", "gates", "hu"), gi_res, gi_res_p, res_tol)
    assert_pairs_close(("dgi", "du", "dv", "ddvec", "dh0", "dc0"), gi_grads,
                       cuda_scan.lstm_scan_bwd_plain(*args[5:], *gi_res_p, dys, dc_last,
                                                     precision), grad_tol)


# (precision, residuals, save_gates) of each variant the scan kernels compile
SCAN_VARIANTS = {"f32": ("f32", "f32", True), "bf16": ("bf16", "f32", True),
                 "bf16_res": ("f32", "bf16", True), "recompute": ("f32", "f32", False)}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [20, 256])
@pytest.mark.parametrize("variant", list(SCAN_VARIANTS))
def test_streamed_plan_is_bit_equal_to_the_resident_plan(cuda, monkeypatch, variant, b):
    """A streamed plan forced at the LM layer's shape with the resident
    plan's groups, CTAs, stage and red: the same sums in the same order,
    wherever a weight row lives, in every entry of each variant (x mode
    and gi mode; the recompute policy is x mode's alone). In bf16, B=20
    keeps the FMA product (groups of 4 rows) and B=256 runs the tensor-core
    one (`ScanPlan.mma`, groups of 32 rows): a resident ring against a
    streamed one."""
    precision, residuals, save = SCAN_VARIANTS[variant]
    elsize = 2 if precision == "bf16" else 4
    t, f, h, rx, r = 35, 650, 650, 300, 300
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    base = cuda_scan.scan_plan(b, h, r, sms, elsize)
    assert not base.streamed and base.mma == (precision == "bf16" and b == 256)
    half = tuple(tuple(d // 2 for d, _ in base.slices(k)) for k in ("fwd", "bwd"))
    forced = cuda_scan.plan_layout(b, h, r, base.groups, base.ctas, elsize, resident=half)
    assert forced.streamed and (forced.stage_fwd, forced.red_fwd, forced.stage_bwd,
                                forced.red_bwd) == (base.stage_fwd, base.red_fwd,
                                                    base.stage_bwd, base.red_bwd)
    args = make_inputs(t, b, f, h, rx, r, cuda)
    gi = cuda_scan._gi_plain(*args[:5], h, False)[1].contiguous()
    dys = torch.from_numpy(0.1 * np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    bias = None if save else args[4]

    def run(plan):
        monkeypatch.setattr(cuda_scan, "_chunks_for", lambda *a, **k: ((0, b, plan),))
        res = cuda_scan.lstm_scan_fused_xin_res(*args, *SCAN_VARIANTS[variant])
        out = [*res, *cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, None,
                                                  bias=bias, precision=precision)]
        if residuals == "f32" and save:  # the no-grad entries' variants are their precisions
            out += [*cuda_scan.lstm_scan_fused_xin(*args, precision),
                    *cuda_scan.lstm_scan_fused(gi, *args[5:], precision)]
        if save:
            gi_res = cuda_scan.lstm_scan_fused_res(gi, *args[5:], precision, residuals)
            out += [*gi_res, *cuda_scan.lstm_scan_bwd(*args[5:], *gi_res, dys, None, precision)]
        return [a for a in out if a is not None]

    resident, streamed = run(base), run(forced)
    torch.cuda.synchronize()
    assert len(resident) == len(streamed)
    for i, (x, y) in enumerate(zip(resident, streamed)):
        assert torch.equal(x, y), i


def ring_outputs(args, gi, dys, dc_last, plan, monkeypatch, precision="f32"):
    """Every output of the six LSTM entries (of ``precision``) on ``plan``."""
    b = args[0].shape[1]
    monkeypatch.setattr(cuda_scan, "_chunks_for", lambda *a, **k: ((0, b, plan),))
    res = cuda_scan.lstm_scan_fused_xin_res(*args, precision)
    gi_res = cuda_scan.lstm_scan_fused_res(gi, *args[5:], precision)
    out = [*cuda_scan.lstm_scan_fused_xin(*args, precision), *res,
           *cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, dc_last,
                                        precision=precision),
           *cuda_scan.lstm_scan_fused(gi, *args[5:], precision), *gi_res,
           *cuda_scan.lstm_scan_bwd(*args[5:], *gi_res, dys, dc_last, precision)]
    torch.cuda.synchronize()
    return [a for a in out if a is not None]


def assert_equal_bits(first, second, label):
    assert len(first) == len(second), label
    for i, (x, y) in enumerate(zip(first, second)):
        assert torch.equal(x, y), f"{label}: output {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case,b", [(case, b) for case in ("dense", "lowrank") for b in (20, 128)])
def test_ring_piece_sizes_give_equal_bits(cuda, monkeypatch, case, b, precision):
    """The streamed plans of the wide layers with ring stages of 8 KB, 24 KB
    and the most that fit beside the slabs, against the chosen plan's (the
    same CTAs, chunks, slices and red; other resident depths): the same
    sums, bit for bit, in all six entries. In bf16 (the tensor-core product
    of `ScanPlan.mma`) the chosen plan is resident at B=20 (staged) and
    streamed at B=128, against plans that stream half of each slice through
    those stages: the ring's pieces and resident blocks keep the order of
    sums either way."""
    t, f, h, rx, r = WIDE_LSTM[case]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    elsize = 2 if precision == "bf16" else 4
    args = make_inputs(t, b, f, h, rx, r, cuda)
    gi = cuda_scan._gi_plain(*args[:5], h, False)[1].contiguous()
    rng = np.random.default_rng(1)
    scale = 0.1 if precision == "bf16" else 1.0
    dys, dc_last = (torch.from_numpy(scale * rng.standard_normal(s).astype(np.float32)).to(cuda)
                    for s in ((t, b, h), (b, h)))
    base = cuda_scan._chunks_for(b, h, r, cuda, precision == "bf16")[0][2]
    assert base.n_ctas == sms and base.mma == (precision == "bf16")
    want = ring_outputs(args, gi, dys, dc_last, base, monkeypatch, precision)
    # in bf16 the weights fit beside small stages: half of each slice streamed
    half = tuple(tuple(d // 2 for d, _ in base.slices(k)) for k in ("fwd", "bwd"))
    for piece in (2048, 6144, 1 << 20):
        plan = (cuda_scan.plan_layout(b, h, r, base.groups, base.ctas, elsize, resident=half,
                                      piece=piece)
                if precision == "bf16" else cuda_scan.streamed_plan(b, h, r, sms, piece=piece))
        assert (plan.stage_fwd, plan.red_fwd, plan.stage_bwd, plan.red_bwd) == (
            base.stage_fwd, base.red_fwd, base.stage_bwd, base.red_bwd)
        assert plan.smem_bytes <= cuda_scan.SMEM_LIMIT and plan.streamed
        assert_equal_bits(want, ring_outputs(args, gi, dys, dc_last, plan, monkeypatch,
                                             precision), piece)


@pytest.mark.cuda
def test_ring_grid_too_large_to_be_co_resident_raises(cuda, monkeypatch):
    """A streamed plan of two groups over all SMs each: more CTAs than can be
    resident at once; every entry raises, none falls back."""
    t, f, h, rx, r = WIDE_LSTM["dense"]
    b = 20
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    one = cuda_scan.streamed_plan(b // 2, h, r, sms)
    plan = cuda_scan.plan_layout(b, h, r, 2, sms, resident=(one.resident_fwd, one.resident_bwd),
                                 ring=(one.piece_fwd, one.piece_bwd))
    assert plan.n_ctas == 2 * sms and plan.smem_bytes <= cuda_scan.SMEM_LIMIT
    monkeypatch.setattr(cuda_scan, "_chunks_for", lambda *a, **k: ((0, b, plan),))
    args = make_inputs(t, b, f, h, rx, r, cuda)
    for fn in (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(*args)


# the GRU's three forms at h=3200 (T=24, B=81): dense "post" is past the
# width whose walk state fits beside weights read through L2, so its walk
# keeps the staged inputs in device memory
WIDE_GRU = {"post": (24, 81, 77, 3200, 9, 0, "post", False),
            "pre": (24, 81, 77, 3200, 9, 0, "pre", False),
            "lowrank_pre": (24, 81, 77, 3200, 9, 800, "pre", True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WIDE_GRU))
def test_wide_gru_forms_match_plain_with_equal_bits(cuda, case, monkeypatch):
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = WIDE_GRU[case]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    form = (cuda_gru.DENSE_POST if mode == "post" else
            cuda_gru.LOWRANK_PRE if lowrank else cuda_gru.DENSE_PRE)
    plan = cuda_gru.gru_plan(t, b, f, rx, h, r, form, sms=sms)
    assert (plan.spill_bwd > 0) == (case == "post")
    monkeypatch.setattr(cuda_gru, "_plan_for", lambda *a, gi=False: plan)  # the row kernels
    args = gru_inputs(*WIDE_GRU[case], cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    fns = (cuda_gru.gru_scan_fused_xin, cuda_gru.gru_scan_fused_xin_res, cuda_gru.gru_scan_xin_bwd)

    def call():
        ys = cuda_gru.gru_scan_fused_xin(*args, mode=mode)
        res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
        return ys, res, cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode)

    before = [fn.launches for fn in fns]
    ys, res, grads = call()
    again = call()
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(fns, before)] == [2, 2, 2]
    for x, y in zip((ys, *res, *grads), (again[0], *again[1], *again[2])):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)
    res_p = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode)
    torch.testing.assert_close(ys, res_p[0], **TOL)
    for name, got, want in zip(("ys", "gates", "hu", "rhu", "recn", "xu"), res, res_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **TOL)
    grads_p = cuda_gru.gru_scan_xin_bwd_plain(*args[:3], *args[4:], *res_p, dys, mode=mode)
    for name, got, want in zip(("dxs", "dux", "dvx", "dbias", "duf", "dprz", "dpn", "dh0"),
                               grads, grads_p):
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, msg=name, **GRAD_TOL)


# -- the grid layout of the GRU kernels (csrc/gru_grid.cuh) -----------------

# (T, B, F, h, rx, r, mode, low-rank recurrent side): odd shapes in each form
# and x side, the HAR GRU at its default width (h=180, dense x side) at the
# train batch, the dense "pre" layer of h=1000 at B=512 (two chunks of
# rows), and the three forms at h=3200, whose slices are streamed
GRID_GRU = {
    "odd_lowrank": (6, 37, 20, 197, 5, 23, "pre", True),
    "odd_dense_pre": (6, 37, 20, 197, 0, 0, "pre", False),
    "odd_post": (6, 37, 20, 197, 5, 0, "post", False),
    "har180_pre": (24, 81, 77, 180, 0, 0, "pre", False),
    "har180_post": (24, 81, 77, 180, 0, 0, "post", False),
    "h1000_pre_b512": (24, 512, 77, 1000, 0, 0, "pre", False),
    "h3200_post": (24, 81, 77, 3200, 9, 0, "post", False),
    "h3200_pre": (24, 81, 77, 3200, 9, 0, "pre", False),
    "h3200_lowrank": (24, 81, 77, 3200, 9, 800, "pre", True),
}
GRID_FNS = ("gru_scan_fused_xin", "gru_scan_fused_xin_res", "gru_scan_xin_bwd",
            "gru_scan_fused", "gru_scan_fused_res", "gru_scan_bwd")


def _gru_form(cuda_gru, mode, lowrank):
    return (cuda_gru.DENSE_POST if mode == "post" else
            cuda_gru.LOWRANK_PRE if lowrank else cuda_gru.DENSE_PRE)


def _grid_calls(cuda_gru, args, dys, mode):
    """Every GRU entry once in each policy: x mode saved gates (no-grad,
    residual forward, BPTT), recompute, gi mode -> {policy: outputs}."""
    gi = cuda_gru._x_side(*args[:4])[1].contiguous()
    rec = (gi, *args[4:])
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    rc = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=False)
    res_gi = cuda_gru.gru_scan_fused_res(*rec, mode=mode)
    return {"nograd": (cuda_gru.gru_scan_fused_xin(*args, mode=mode),),
            "saved": (*res, *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys,
                                                       mode=mode)),
            "recompute": (*rc, *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *rc, dys,
                                                          mode=mode, bias=args[3])),
            "gi": (cuda_gru.gru_scan_fused(*rec, mode=mode), *res_gi,
                   *cuda_gru.gru_scan_bwd(*args[4:], *res_gi, dys, mode=mode))}


def _grid_plain(cuda_gru, args, dys, mode):
    """`_grid_calls`'s outputs from the plain versions."""
    gi = cuda_gru._x_side(*args[:4])[1].contiguous()
    res = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode)
    saved = (*args[:3], *args[4:], *res)
    rec = cuda_gru.gru_recurrence_plain(gi, *args[4:], mode=mode)
    return {"nograd": (res[0],),
            "saved": (*res, *cuda_gru.gru_scan_xin_bwd_plain(*saved, dys, mode=mode)),
            "recompute": (res[0], None, None, None, None, None,
                          *cuda_gru.gru_scan_xin_bwd_plain(*saved, dys, mode=mode)),
            "gi": (rec[0], *rec, *cuda_gru.gru_scan_bwd_plain(*args[4:], *rec, dys, mode=mode))}


# which outputs of each policy are gradients (GRAD_TOL), the others TOL
GRID_FORWARD_OUTS = {"nograd": 1, "saved": 6, "recompute": 6, "gi": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRID_GRU))
def test_gru_grid_entries_match_plain_with_equal_bits(cuda, case, monkeypatch):
    """All six entries on the grid layout (forced where `gru_layout` keeps
    the row kernels) against their plain versions, two calls to equal bits,
    one cooperative launch a chunk of rows."""
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = GRID_GRU[case]
    form = _gru_form(cuda_gru, mode, lowrank)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunks = {g: cuda_gru.gru_grid_chunks(t, b, 0 if g else f, 0 if g else rx, h, r, form,
                                          gi=g, sms=sms) for g in (False, True)}
    monkeypatch.setattr(cuda_gru, "_plan_for", lambda *a, gi=False: chunks[gi])
    if case.startswith("h3200") or case.startswith("har180"):  # the wrappers' own choice
        for kernel in ("fwd", "bwd"):
            assert cuda_gru.gru_layout(t, b, f, rx, h, r, form, kernel=kernel,
                                       sms=sms) == chunks[False]
    if case == "h1000_pre_b512":
        assert len(chunks[False]) == 2
    args = gru_inputs(*GRID_GRU[case], cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    fns = [getattr(cuda_gru, n) for n in GRID_FNS]
    before = [fn.launches for fn in fns]
    first = _grid_calls(cuda_gru, args, dys, mode)
    second = _grid_calls(cuda_gru, args, dys, mode)
    torch.cuda.synchronize()
    n = len(chunks[False])
    assert [fn.launches - k for fn, k in zip(fns, before)] == [2 * n, 4 * n, 4 * n, 2 * n, 2 * n,
                                                                2 * n]
    want = _grid_plain(cuda_gru, args, dys, mode)
    for policy, outs in first.items():
        for i, (x1, x2, w) in enumerate(zip(outs, second[policy], want[policy])):
            assert (x1 is None) == (x2 is None), (policy, i)
            if x1 is None:
                continue
            assert torch.equal(x1, x2), (policy, i)
            if w is not None:
                tol = TOL if i < GRID_FORWARD_OUTS[policy] else GRAD_TOL
                torch.testing.assert_close(x1, w, msg=f"{policy} {i}", **tol)


# (T, B, F, h, rx, r, mode, low-rank): a resident grid plan, and the same
# groups and CTAs with a share of each slice's rows streamed
GRID_STREAMED = {"post": (6, 37, 20, 197, 5, 0, "post", False),
                 "pre": (6, 37, 20, 197, 0, 0, "pre", False),
                 "lowrank_pre": (6, 37, 20, 197, 5, 23, "pre", True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRID_STREAMED))
def test_gru_forced_streamed_grid_plan_is_bit_equal_to_the_resident_one(cuda, case,
                                                                        monkeypatch):
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = GRID_STREAMED[case]
    form = _gru_form(cuda_gru, mode, lowrank)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    resident = cuda_gru.gru_grid_plan(t, b, f, rx, h, r, form, sms=sms)
    assert not resident.streamed
    # a third of each slice's rows resident, the rest streamed
    part = tuple(tuple(d // 3 for d, _ in resident.slices(k)) for k in ("fwd", "bwd"))
    streamed = cuda_gru.grid_plan_layout(b, h, r, form, resident.groups, resident.ctas,
                                         resident=part)
    # the streamed rows go through the TMA ring, whose stages take the room
    # the rows left
    assert streamed.streamed and streamed.piece_fwd and streamed.piece_bwd
    assert all(sum(streamed.resident(k)) < sum(resident.resident(k)) for k in ("fwd", "bwd"))
    args = gru_inputs(*GRID_STREAMED[case], cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    runs = []
    for plan in (resident, streamed):
        monkeypatch.setattr(cuda_gru, "_plan_for", lambda *a, gi=False, p=plan: ((0, b, p),))
        runs.append(_grid_calls(cuda_gru, args, dys, mode))
    torch.cuda.synchronize()
    for policy, outs in runs[0].items():
        for i, (x, y) in enumerate(zip(outs, runs[1][policy])):
            assert (x is None) == (y is None), (policy, i)
            if x is not None:
                assert torch.equal(x, y), (policy, i)


def _grid_runs_bit_equal(cuda_gru, monkeypatch, shape, plans):
    """`_grid_calls` on each plan of ``plans`` at ``shape`` (GRID_GRU's
    fields): every output of the first bit-equal to the others'."""
    t, b, f, h, rx, r, mode, lowrank = shape
    args = gru_inputs(*shape, torch.device("cuda"))
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).cuda()
    runs = []
    for plan in plans:
        monkeypatch.setattr(cuda_gru, "_plan_for", lambda *a, gi=False, p=plan: ((0, b, p),))
        runs.append(_grid_calls(cuda_gru, args, dys, mode))
    torch.cuda.synchronize()
    for run in runs[1:]:
        for policy, outs in runs[0].items():
            for i, (x, y) in enumerate(zip(outs, run[policy])):
                assert (x is None) == (y is None), (policy, i)
                if x is not None:
                    assert torch.equal(x, y), (policy, i)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["h3200_post", "h3200_pre", "h3200_lowrank"])
def test_gru_ring_pieces_keep_the_bits(cuda, case, monkeypatch):
    """At h=3200 every grid kernel runs on the TMA ring; rings of 6144- and
    12288-float stages (more pieces a product, more rows resident; the same
    groups, CTAs, chunks and red) give every entry's outputs bit-equal to
    the chosen ring's."""
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = GRID_GRU[case]
    form = _gru_form(cuda_gru, mode, lowrank)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chosen = cuda_gru.gru_grid_plan(t, b, f, rx, h, r, form, sms=sms)
    others = [cuda_gru.grid_streamed_plan(b, h, r, form, sms, piece=p) for p in (6144, 12288)]
    assert chosen.piece_fwd and chosen.piece_bwd
    for other in others:
        assert (other.groups, other.ctas, other.stage_fwd, other.stage_bwd) == (
            chosen.groups, chosen.ctas, chosen.stage_fwd, chosen.stage_bwd)
        assert sum(other.resident_fwd) > sum(chosen.resident_fwd)
    _grid_runs_bit_equal(cuda_gru, monkeypatch, GRID_GRU[case], [chosen, *others])


def _tile_plan(cuda_gru, case, tile, sms, piece=None, rows=None):
    """GRID_GRU[case]'s plan (its first chunk of rows) with items of ``tile``
    rows: the chosen plan's groups, but no more than groups of ``rows`` rows
    (default ``tile``) fill, and its CTAs, or the fewest more whose shared
    memory holds ``rows``-row groups; on a ring (of ``piece``-float stages
    where given) where it streams -> (its rows, the plan)."""
    t, b, f, h, rx, r, mode, lowrank = GRID_GRU[case]
    form = _gru_form(cuda_gru, mode, lowrank)
    (_, b, chosen), *_ = cuda_gru.gru_grid_chunks(t, b, f, rx, h, r, form, sms=sms)
    if chosen.streamed:
        return b, cuda_gru.grid_streamed_plan(b, h, r, form, sms, piece=piece, tile=tile)
    groups = min(chosen.groups, -(-b // (rows or tile)))
    ctas = next(c for c in range(chosen.ctas, sms // groups + 1) if cuda_gru.grid_plan_layout(
        b, h, r, form, groups, c, tile=rows or tile).smem_bytes <= cuda_gru.SMEM_LIMIT)
    return b, cuda_gru.grid_plan_layout(b, h, r, form, groups, ctas, tile=tile)


TILE_CASES = ("odd_lowrank", "odd_dense_pre", "odd_post", "h1000_pre_b512", "h3200_post",
              "h3200_pre", "h3200_lowrank")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 12])
@pytest.mark.parametrize("case", TILE_CASES)
def test_gru_grid_tiles_match_plain_and_four_row_items(cuda, case, tile, monkeypatch):
    """Items of 8 and 12 batch rows in both kernels (GRUGridPlan.tile_fwd
    and tile_bwd, forced; rows padded to a
    multiple of them, other slices): every entry (x mode, recompute, gi
    mode) within TOL (outputs) and GRAD_TOL (gradients) of its plain version
    and of the same plan's items of 4 rows, two calls to equal bits."""
    from vmlmf_tpu_torch.ops import cuda_gru

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    b, plan = _tile_plan(cuda_gru, case, tile, sms)
    _, four = _tile_plan(cuda_gru, case, 4, sms, rows=tile)  # the same groups and CTAs
    assert plan.tile_fwd == plan.tile_bwd == tile and plan.rpad % tile == 0
    assert four.tile_fwd == four.tile_bwd == 4
    assert (four.groups, four.ctas) == (plan.groups, plan.ctas)
    assert max(plan.smem_bytes, four.smem_bytes) <= cuda_gru.SMEM_LIMIT
    t, _, f, h, rx, r, mode, lowrank = GRID_GRU[case]
    shape = (t, b, f, h, rx, r, mode, lowrank)
    args = gru_inputs(*shape, cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    runs = []
    for p in (plan, plan, four):
        monkeypatch.setattr(cuda_gru, "_plan_for", lambda *a, gi=False, p=p: ((0, b, p),))
        runs.append(_grid_calls(cuda_gru, args, dys, mode))
    torch.cuda.synchronize()
    want = _grid_plain(cuda_gru, args, dys, mode)
    for policy, outs in runs[0].items():
        for i, (x, again, x4, w) in enumerate(zip(outs, runs[1][policy], runs[2][policy],
                                                  want[policy])):
            assert (x is None) == (again is None) == (x4 is None), (policy, i)
            if x is None:
                continue
            assert torch.equal(x, again), (policy, i)
            tol = TOL if i < GRID_FORWARD_OUTS[policy] else GRAD_TOL
            torch.testing.assert_close(x, x4, msg=f"{policy} {i} against R=4", **tol)
            if w is not None:
                torch.testing.assert_close(x, w, msg=f"{policy} {i}", **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 12])
@pytest.mark.parametrize("case", ["odd_lowrank", "odd_dense_pre", "odd_post", "h3200_post",
                                  "h3200_pre", "h3200_lowrank"])
def test_gru_tile_plans_keep_the_bits_streamed_and_on_other_rings(cuda, case, tile,
                                                                  monkeypatch):
    """At items of 8 and 12 rows, as at 4: the odd shapes' resident plan and
    the same plan with a third of each slice streamed through the ring, and
    at h=3200 the plan's ring and one of 6144-float stages, give every
    entry's outputs bit-equal."""
    from vmlmf_tpu_torch.ops import cuda_gru

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    b, plan = _tile_plan(cuda_gru, case, tile, sms)
    assert plan.smem_bytes <= cuda_gru.SMEM_LIMIT
    if plan.streamed:
        _, other = _tile_plan(cuda_gru, case, tile, sms, piece=6144)
        assert other.piece_fwd == 6144 and sum(other.resident_fwd) > sum(plan.resident_fwd)
    else:
        part = tuple(tuple(d // 3 for d, _ in plan.slices(k)) for k in ("fwd", "bwd"))
        other = cuda_gru.grid_plan_layout(b, plan.h, plan.r, plan.form, plan.groups, plan.ctas,
                                          resident=part, tile=tile)
        assert other.streamed and other.piece_fwd and other.piece_bwd
    for field in ("tile_fwd", "tile_bwd", "rpad", "groups", "ctas", "stage_fwd", "red_fwd",
                  "stage_bwd", "red_bwd"):
        assert getattr(other, field) == getattr(plan, field), field
    t, _, f, h, rx, r, mode, lowrank = GRID_GRU[case]
    _grid_runs_bit_equal(cuda_gru, monkeypatch, (t, b, f, h, rx, r, mode, lowrank),
                         [plan, other])


@pytest.mark.cuda
def test_gru_chunked_exchange_ring_is_bit_equal_to_the_staging_buffer(cuda, monkeypatch):
    """h=1000 at B=256 (a chunk of B=512): every row resident, each exchange
    staged in chunks by slice_product's two halves of the staging buffer; a
    ring forced into the staging buffer's room gives every entry's outputs
    bit-equal."""
    from vmlmf_tpu_torch.ops import cuda_gru
    from vmlmf_tpu_torch.tools.gru_phases import ring_in_stage

    t, _, f, h, rx, r, mode, lowrank = GRID_GRU["h1000_pre_b512"]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    (_, b, plan), _ = cuda_gru.gru_grid_chunks(t, 512, f, rx, h, r, cuda_gru.DENSE_PRE, sms=sms)
    ring = ring_in_stage(plan)
    assert not plan.piece_fwd and ring.piece_fwd and ring.piece_bwd and not ring.streamed
    _grid_runs_bit_equal(cuda_gru, monkeypatch, (t, b, f, h, rx, r, mode, lowrank), [plan, ring])


@pytest.mark.cuda
def test_gru_bptt_products_on_the_hopper_tile_match_float64(cuda):
    """Each GRU BPTT product that gemm_tc.cuh's rule sends to its Hopper tile
    at h=3200 (T=24, B=81, r=800), its composite operands staged through a
    gated source: in 3xTF32 within 1e-5 of float64 and within twice
    gemm_tile.cuh's CUDA-core split-k's error at the same product; two calls
    to equal bits."""
    from vmlmf_tpu_torch.ops import tc_check
    from vmlmf_tpu_torch.ops.cuda_scan import tc_route

    t, b, h, r = 24, 81, 3200, 800
    m = t * b
    g = torch.Generator().manual_seed(3)

    def n(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).cuda()

    h0, ys, gates = n(b, h, scale=0.5), torch.tanh(n(t, b, h)), torch.sigmoid(n(t, b, 3 * h))
    dpre = n(m, 3 * h, scale=0.1)
    v = dict(hu=n(m, r), rhu=n(m, r), dhu=n(m, r, scale=0.1), drhu=n(m, r, scale=0.1),
             w=n(h, r, scale=h ** -0.5))
    for p, (label, shape, _, _) in enumerate(tc_check.GRU_PRODUCTS):
        assert tc_route(*shape(m, h, r, r)), label
        a, bb = tc_check.gru_sources(p, h0, ys, gates, dpre, **v)
        got = tc_check.gru_product(p, tc_check.GRU_HOPPER, h0, ys, gates, dpre, **v)
        again = tc_check.gru_product(p, tc_check.GRU_HOPPER, h0, ys, gates, dpre, **v)
        tile = tc_check.gru_product(p, tc_check.GRU_TILE, h0, ys, gates, dpre, **v)
        torch.cuda.synchronize()
        assert torch.equal(got, again), label
        err, tile_err = (tc_check.relative_error(x, a, bb) for x in (got, tile))
        print(f"{label}: Hopper tile {err:.3g}, gemm_tile.cuh {tile_err:.3g}")
        assert err <= min(1e-5, 2 * tile_err), (label, err, tile_err)
        del a, bb


@pytest.mark.cuda
def test_gru_grid_too_large_to_be_co_resident_raises(cuda, monkeypatch):
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = GRID_GRU["odd_post"]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = cuda_gru.grid_plan_layout(b, h, r, cuda_gru.DENSE_POST, 2, sms)  # 2 x sms CTAs
    monkeypatch.setattr(cuda_gru, "_plan_for", lambda *a, gi=False: ((0, b, plan),))
    args = gru_inputs(*GRID_GRU["odd_post"], cuda)
    with pytest.raises(RuntimeError, match="gru_grid_fwd launch failed"):
        cuda_gru.gru_scan_fused_xin(*args, mode=mode)


@pytest.mark.cuda
def test_graphed_har_gru_block_at_its_default_width_equals_eager(cuda):
    """`har_main --model mygru` at its defaults: a dense "pre" GRU of 180
    units with a dense x side, whose kernels take the grid layout; a
    graphed block of train steps bit-equal to the same steps run eagerly."""
    from vmlmf_tpu_torch.config import HARConfig
    from vmlmf_tpu_torch.ops import cuda_gru
    from vmlmf_tpu_torch.train.har import HARTrainer

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    layout = cuda_gru.gru_layout(24, 81, 77, 0, 180, 0, cuda_gru.DENSE_PRE, sms=sms)
    assert not isinstance(layout, cuda_gru.GRUPlan)
    model = HARConfig(model="mygru").build_model()
    trainer = HARTrainer(model, batch_size=81, device=cuda)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((5, 81, 24, 77)).astype(np.float32)).to(cuda)
    ys = torch.from_numpy(rng.integers(0, 18, (5, 81))).to(cuda)
    (pa, oa), (pb, ob) = trainer.init(), trainer.init()
    pa, oa, la = trainer._fused_steps(pa, oa, xs, ys)
    lb = []
    before = cuda_gru.gru_scan_xin_bwd.launches
    for x, y in zip(xs, ys):
        pb, ob, loss = trainer.train_step(pb, ob, x, y)
        lb.append(loss)
    assert cuda_gru.gru_scan_xin_bwd.launches - before == 5  # one cooperative launch a step
    assert torch.equal(la, torch.stack(lb)) and _equal(pa, pb)
    assert _equal([s for st in oa.state.values() for s in st.values()],
                  [s for st in ob.state.values() for s in st.values()])


# a spill forced at a small width (h=64: one row a CTA, every weight read
# through L2, one step a block) with none, the first non-empty region and
# every region of each kernel in device memory: the same bits
GRU_SPILL = {"post": ("post", False, 0), "pre": ("pre", False, 0),
             "lowrank_pre": ("pre", True, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["x", "gi", "recompute"])
@pytest.mark.parametrize("case", list(GRU_SPILL))
def test_gru_forced_spill_is_bit_equal_to_the_unspilled_layout(cuda, monkeypatch, case, path):
    from vmlmf_tpu_torch.ops import cuda_gru

    mode, lowrank, r = GRU_SPILL[case]
    t, b, f, h, rx = 24, 81, 77, 64, 9
    form = (cuda_gru.DENSE_POST if mode == "post" else
            cuda_gru.LOWRANK_PRE if lowrank else cuda_gru.DENSE_PRE)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    args = gru_inputs(t, b, f, h, rx, r, mode, lowrank, cuda)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)).astype(
        np.float32)).to(cuda)
    gi = cuda_gru._x_side(*args[:4])[1].contiguous()
    rec = (gi, *args[4:])

    def run(regions):
        plans = {g: cuda_gru.spill_plan(t, b, 0 if g else f, 0 if g else rx, h, r, form,
                                        regions, gi=g, sms=sms) for g in (False, True)}
        monkeypatch.setattr(cuda_gru, "_plan_for", lambda *a, gi=False: plans[gi])
        if path == "x":
            res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
            out = (cuda_gru.gru_scan_fused_xin(*args, mode=mode), *res,
                   *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode))
        elif path == "gi":
            res = cuda_gru.gru_scan_fused_res(*rec, mode=mode)
            out = (cuda_gru.gru_scan_fused(*rec, mode=mode), *res,
                   *cuda_gru.gru_scan_bwd(*args[4:], *res, dys, mode=mode))
        else:
            res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=False)
            out = (*res, *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode,
                                                    bias=args[3]))
        return plans[path == "gi"], [a for a in out if a is not None]

    (none, want), (first, one), (every, all_) = (run(k) for k in ((0, 0), (1, 1), (99, 99)))
    torch.cuda.synchronize()
    assert none.spill_fwd == none.spill_bwd == 0 and every.smem_fwd == every.smem_bwd == 0
    assert 0 < first.spill_fwd < every.spill_fwd and 0 < first.spill_bwd < every.spill_bwd
    for got in (one, all_):
        assert len(got) == len(want)
        for i, (x, y) in enumerate(zip(want, got)):
            assert torch.equal(x, y), i
    ys = want[0]  # and the unspilled layout against the plain scan
    torch.testing.assert_close(ys, cuda_gru.gru_scan_fused_xin_plain(*args, mode=mode), **TOL)


# -- the tensor-core GEMM of the LSTM scans (csrc/gemm_tc.cuh) --------------

# the view of A and of B -> (a_kind, b_kind) of csrc/gemm_tc_check.cu;
# PrevRows reads [h0; ys] in place; masked_t is the stack's X^T, X = y *
# mask written first into the staging scratch (Staging::masked)
TC_VIEWS = {"row_row": (0, 0), "row_t": (0, 1), "t_row": (1, 0), "prev": (2, 0),
            "prev_t": (3, 0), "masked_t": (4, 0)}
# (m, n, k): odd edges on every side (and lda = 45, unaligned rows); the LM
# layer's dV-like product, split k; a dense h=1500 projection, large tiles
TC_SHAPES = {"odd": (45, 37, 53), "split": (300, 2600, 700), "large": (700, 6000, 1500)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(TC_SHAPES))
@pytest.mark.parametrize("view", list(TC_VIEWS))
def test_tc_tile_matches_float64(cuda, view, shape, precision):
    """The tile alone against a float64 product of the same (for bf16,
    bf16-rounded) operands: 3xTF32 keeps f32's precision (one-pass TF32
    would be about 1e-4 off), bf16 mma sums exact products in f32. Two
    equal calls give equal bits."""
    from vmlmf_tpu_torch.ops.tc_check import operands, relative_error, tc_product

    m, n, k = TC_SHAPES[shape]
    a_kind, b_kind = TC_VIEWS[view]
    rng = np.random.default_rng(7)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)

    nfirst = 7
    if a_kind == 0:
        a0, a1, lda = t(m, k), None, k
    elif a_kind == 1:
        a0, a1, lda = t(k, m), None, m
    elif a_kind == 2:  # rows of [a0; a1], the seam after row nfirst
        a0, a1, lda = t(nfirst, k), t(m - nfirst, k), k
    elif a_kind == 3:  # A = [a0; a1]^T, the seam after column nfirst
        a0, a1, lda = t(nfirst, m), t(k - nfirst, m), m
    else:  # A = (a0 * a1)^T, a1 a dropout mask at rate 0.5
        a0, a1, lda = t(k, m), torch.from_numpy(
            (rng.random((k, m)) < 0.5).astype(np.float32) / 0.5).to(cuda), m
    b0, ldb = (t(k, n), n) if b_kind == 0 else (t(n, k), k)
    a, b = operands(a_kind, b_kind, a0, a1, b0)
    bf16 = precision == "bf16"
    runs = [tc_product(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, m, n, k, bf16)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    if bf16:
        a, b = a.bfloat16().float(), b.bfloat16().float()
    err = relative_error(runs[0], a, b)
    assert err < 1e-5, err
    if shape == "split":  # the same product unsplit, to the same tolerance
        whole = tc_product(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, m, n, k, bf16,
                           split=False)
        assert relative_error(whole, a, b) < 1e-5
    for tile in (1, 2, 3):  # each tile at every shape, whichever the plan takes
        got = tc_product(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, m, n, k, bf16,
                         tile=tile)
        assert relative_error(got, a, b) < 1e-5, tile


# (m, n, k) for the Hopper tile alone: odd m, n and k (lda = 45, rows that
# are not 16-byte aligned); h=650 strides (2600-byte f32 rows, 1300-byte
# bf16 ones) over the LM layer's dx = dPre Ux^T; a k of one partial stage;
# the dense h=1500 layer's products at B=128 (gi and dx; dU and dUx below)
HOPPER_SHAPES = {"odd": (45, 37, 53), "h650": (700, 650, 2600), "short_k": (300, 200, 5),
                 "gi_b128": (4480, 6000, 1500), "dx_b128": (4480, 1500, 6000),
                 "du_b128": (1500, 6000, 4480)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(HOPPER_SHAPES))
@pytest.mark.parametrize("view", list(TC_VIEWS))
def test_hopper_tile_matches_float64(cuda, view, shape, precision):
    """The Hopper tile (wgmma fed by TMA from staged copies) forced at each
    view and shape, split k by its own plan: within 1e-5 of a float64
    product of the same (bf16-rounded) operands, the PrevRows seam (after
    row or column 7) inside a k tile, and two equal calls give equal
    bits."""
    from vmlmf_tpu_torch.ops.tc_check import HOPPER, operands, relative_error, tc_product

    m, n, k = HOPPER_SHAPES[shape]
    a_kind, b_kind = TC_VIEWS[view]
    if shape.endswith("_b128") and (a_kind in (1, 3, 4)) != (shape == "du_b128"):
        pytest.skip("a B=128 product is checked at the views the scans give it")
    rng = np.random.default_rng(11)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)

    nfirst = min(7, (k if a_kind == 3 else m) - 1)
    if a_kind == 0:
        a0, a1, lda = t(m, k), None, k
    elif a_kind == 1:
        a0, a1, lda = t(k, m), None, m
    elif a_kind == 2:
        a0, a1, lda = t(nfirst, k), t(m - nfirst, k), k
    elif a_kind == 3:
        a0, a1, lda = t(nfirst, m), t(k - nfirst, m), m
    else:
        a0, a1, lda = t(k, m), torch.from_numpy(
            (rng.random((k, m)) < 0.5).astype(np.float32) / 0.5).to(cuda), m
    b0, ldb = (t(k, n), n) if b_kind == 0 else (t(n, k), k)
    a, b = operands(a_kind, b_kind, a0, a1, b0)
    bf16 = precision == "bf16"
    runs = [tc_product(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, m, n, k, bf16,
                       tile=HOPPER) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    if bf16:
        a, b = a.bfloat16().float(), b.bfloat16().float()
    err = relative_error(runs[0], a, b)
    assert err < 1e-5, err


@pytest.mark.cuda
def test_tc_plan_mirror_equals_the_header_s(cuda):
    """ops/cuda_scan.py::tc_plan against gemm_tc.cuh's own (read through
    gemm_tc_check.cu) at every product of the HAR, PTB medium and dense
    h=1500 layers at B = 1, 20, 81, 128, in both precisions, with the
    split-k room the scans give them and with none."""
    from vmlmf_tpu_torch.ops.tc_check import card_plan

    layers = {"har": (24, 77, 180, 8, 6), "har_dense": (24, 77, 180, 0, 0),
              "lm": (35, 650, 650, 300, 300), "lm_dense": (35, 650, 650, 0, 0),
              "dense1500": (35, 1500, 1500, 0, 0), "lowrank1500": (35, 1500, 1500, 750, 750)}
    for t, f, h, rx, r in layers.values():
        for b in (1, 20, 81, 128):
            for entry, extra in (("fwd", {}), ("bwd", {"recompute": True})):
                for bf16 in (False, True):
                    floats = cuda_scan.bwd_partial_floats(t, b, f, rx, h, r, bf16=bf16, **extra)
                    for m, n, k, _, _, split, _ in cuda_scan.gemm_products(t, b, f, rx, h, r,
                                                                           entry, **extra):
                        for room in {0, floats // (m * n) if split else 0}:
                            want = cuda_scan.tc_plan(m, n, k, room, bf16)
                            assert card_plan(m, n, k, room, bf16) == want, (m, n, k, room)


@pytest.mark.cuda
def test_hopper_cast_rounds_as_bf16_pair(cuda):
    """The Hopper tile's bf16 cast pass rounds to nearest even, as torch's
    .bfloat16() and the Ampere tile's bf16_pair do: bit-equal on values
    with ties (both parities), subnormals of both types, signed zeros,
    infinities and odd row lengths (the padding to 8 elements)."""
    from vmlmf_tpu_torch.ops.tc_check import tc_cast

    bits = np.concatenate([
        np.array([0x3F808000, 0x3F818000, 0x3F80C000, 0x3F817FFF, 0x00008000, 0x00018000,
                  0x00000001, 0x007FFFFF, 0x80008000, 0x00000000, 0x80000000, 0x7F800000,
                  0xFF800000, 0x7F7FFFFF, 0x0080FFFF], dtype=np.uint32),
        np.random.default_rng(3).integers(0, 2 ** 32, 7 * 33 - 15, dtype=np.uint64)
        .astype(np.uint32)])
    bits = bits[np.isfinite(bits.view(np.float32)) | (np.abs(bits.view(np.float32)) == np.inf)]
    vals = torch.from_numpy(bits[:7 * 29].view(np.float32).reshape(7, 29).copy())
    got = tc_cast(vals.to(cuda)).cpu()
    assert torch.equal(got.view(torch.int16), vals.bfloat16().view(torch.int16))


# (T, B, F, h, rx, r): no m, n or k a multiple of a tile (m = 21, F = 37,
# 4h = 180, rx = 11, r = 13) low-rank and dense; the LM layer at B=20 and
# at B=256 (in bf16 the tensor-core walk, low-rank, resident); the dense
# h=1500 layer at B=20 (its products 12.6 GFLOP each) and 128
TC_ENTRY_CASES = {"odd": (3, 7, 37, 45, 11, 13), "odd_dense": (3, 7, 37, 45, 0, 0),
                  "lm_b20": (35, 20, 650, 650, 300, 300),
                  "lm_b256": (35, 256, 650, 650, 300, 300),
                  "dense1500_b20": (35, 20, 1500, 1500, 0, 0),
                  "dense1500_b128": (35, 128, 1500, 1500, 0, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(SCAN_VARIANTS))
@pytest.mark.parametrize("case", list(TC_ENTRY_CASES))
def test_tc_scan_entries_match_plain_and_repeat(cuda, case, variant):
    """Every entry of the two LSTM scan kernels (no-grad, residual and BPTT,
    x mode and, where the variant has it, gi mode) at shapes that run the
    tensor-core GEMMs on both tiles and split k: each within its variant's
    tolerance of its plain version, and two equal calls to equal bits."""
    precision, residuals, save = SCAN_VARIANTS[variant]
    t, b, f, h, rx, r = TC_ENTRY_CASES[case]
    args = make_inputs(t, b, f, h, rx, r, cuda)
    rng = np.random.default_rng(1)
    dys, dc_last = (torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)).to(cuda)
                    for s in ((t, b, h), (b, h)))
    gi = cuda_scan._gi_plain(*args[:5], h, False)[1].contiguous()
    bias = None if save else args[4]

    def run():
        fwd = cuda_scan.lstm_scan_fused_xin(*args, precision)
        res = cuda_scan.lstm_scan_fused_xin_res(*args, precision, residuals, save)
        grads = cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, dc_last, bias=bias,
                                            precision=precision)
        out = {"fwd": fwd, "res": res, "grads": grads}
        if save:
            gi_res = cuda_scan.lstm_scan_fused_res(gi, *args[5:], precision, residuals)
            out.update(gi_fwd=cuda_scan.lstm_scan_fused(gi, *args[5:], precision), gi_res=gi_res,
                       gi_grads=cuda_scan.lstm_scan_bwd(*args[5:], *gi_res, dys, dc_last,
                                                        precision))
        return out

    first, second = run(), run()
    torch.cuda.synchronize()
    for key in first:
        for i, (x, y) in enumerate(zip(first[key], second[key])):
            assert (x is None and y is None) or torch.equal(x, y), (key, i)
    fwd_tol, res_tol, grad_tol = variant_tols(precision, residuals)
    assert_pairs_close(("ys", "c_last"), first["fwd"],
                       cuda_scan.lstm_scan_fused_xin_plain(*args, precision), fwd_tol)
    res_p = cuda_scan.lstm_scan_xin_fwd_res_plain(*args, precision, residuals, save)
    assert_pairs_close(("ys", "cs", "gates", "hu", "xu"), first["res"], res_p, res_tol)
    assert_pairs_close(cuda_scan._ARG_NAMES, first["grads"],
                       cuda_scan.lstm_scan_xin_bwd_plain(*args[:4], *args[5:], *res_p, dys,
                                                         dc_last, bias=bias,
                                                         precision=precision), grad_tol)
    if save:
        assert_pairs_close(("ys", "c_last"), first["gi_fwd"],
                           cuda_scan.lstm_scan_fused_plain(gi, *args[5:], precision), fwd_tol)
        gi_res_p = cuda_scan.lstm_recurrence_plain(gi, *args[5:], precision, residuals)
        assert_pairs_close(("ys", "cs", "gates", "hu"), first["gi_res"], gi_res_p, res_tol)
        assert_pairs_close(("dgi", "du", "dv", "ddvec", "dh0", "dc0"), first["gi_grads"],
                           cuda_scan.lstm_scan_bwd_plain(*args[5:], *gi_res_p, dys, dc_last,
                                                         precision), grad_tol)


# (depth, cols, rpad) of the bf16 walk's products: the dense h=1500 layer's
# forward and BPTT slices at B=20 and 128, the LM layer's at B=128, and odd
# edges (a depth short of a block, columns short of a tile, one n-tile)
MMA_PRODUCTS = {"dense_fwd_b20": (1500, 48, 24), "dense_bwd_b20": (6000, 12, 24),
                "dense_fwd_b128": (1500, 48, 128), "dense_bwd_b128": (6000, 12, 128),
                "lm_fwd_b128": (650, 24, 16), "lm_gates_b128": (300, 200, 16),
                "odd": (37, 12, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MMA_PRODUCTS))
def test_mma_walk_product_matches_float64(cuda, case):
    """scan_grid.cuh's tensor-core product alone (csrc/mma_walk_check.cu):
    every block resident, within 1e-5 of a float64 product of the same bf16
    operands, and two equal calls to equal bits; every block streamed
    (stages of 16 KB and 80 KB) or half of them (16 KB and 24 KB),
    bit-equal to it (the order of sums does not depend on where a row
    lies)."""
    from vmlmf_tpu_torch.ops.mma_check import mma_walk_product, relative_error

    depth, cols, rpad = MMA_PRODUCTS[case]
    rng = np.random.default_rng(11)
    w, a = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
            for s in ((depth, cols), (depth, rpad)))
    staged = [mma_walk_product(w, a, rpad) for _ in range(2)]  # every block resident
    torch.cuda.synchronize()
    assert torch.equal(staged[0], staged[1])
    err = relative_error(staged[0], w, a)
    assert err < 1e-5, err
    half = depth // 2 // cuda_scan.MMA_K * cuda_scan.MMA_K
    for resident, piece in ((0, 4096), (0, cuda_scan.RING_PIECE_FLOATS), (half, 4096),
                            (half, 6144)):
        ring = mma_walk_product(w, a, rpad, resident=resident, piece=piece)
        torch.cuda.synchronize()
        assert torch.equal(ring, staged[0]), (resident, piece)
