"""Fault 9: batches that the per-layer LSTM scan's plan cannot take in one
launch run in chunks of rows (`cuda_scan.scan_chunks`), on the CPU.

`scan_plan` gives every CTA of a batch group that group's rows, so past
some batch no grouping fits in shared memory: B=657 at the PTB VMLMF LM
layer (h=650, r=300) in f32, B=833 with bf16 weights, B=477 at the dense
LM layer, B=141 at a dense h=1000 layer, B=3561 at the HAR layer (h=180,
r=6). Here every such batch, up to 4096, is cut into chunks that each have
a plan and together cover every row once, and a batch that has a plan stays
one chunk. Then the six scan entries run on CPU tensors as they run on the
card, each chunk through a stand-in for its launch that computes the plain
version on the chunk's rows, and are held to the plain version on the
whole batch and to the JAX package's kernel (Pallas in interpret mode).
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.ops.pallas_scan import lstm_scan_fused_xin as jax_scan  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402

SMS = 132  # an H100 SXM
FWD_TOL = dict(atol=2e-5, rtol=2e-5)  # f32 (tests/test_pallas.py:57, :74)
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)
BF16_TOL, BF16_GRAD_TOL = dict(atol=5e-3, rtol=5e-3), dict(atol=5e-2, rtol=5e-2)  # (:97, :114)

# (h, r, weight bytes) -> the last batch with a plan
SHAPES = {
    "lm_vmlmf": ((650, 300, 4), 656),
    "lm_vmlmf_bf16": ((650, 300, 2), 832),
    "lm_dense": ((650, 0, 4), 476),
    "dense_1000": ((1000, 0, 4), 140),
    "har": ((180, 6, 4), 3560),
}
BATCHES = (1, 20, 128, 140, 141, 256, 476, 477, 512, 656, 657, 832, 833, 1024, 2048, 3560,
           3561, 4096)


@pytest.mark.parametrize("name", list(SHAPES))
def test_the_plan_ends_where_the_fault_begins(name):
    (h, r, elsize), last = SHAPES[name]
    cuda_scan.scan_plan(last, h, r, SMS, elsize)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_scan.scan_plan(last + 1, h, r, SMS, elsize)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_chunks_cover_every_row_once_and_each_has_a_plan(name, b):
    (h, r, elsize), _ = SHAPES[name]
    chunks = cuda_scan.scan_chunks(b, h, r, SMS, elsize)
    rows = np.zeros(b, int)
    for b0, n, plan in chunks:
        assert n >= 1 and plan == cuda_scan.scan_plan(n, h, r, SMS, elsize)
        assert plan.b == n and plan.smem_bytes <= cuda_scan.SMEM_LIMIT
        rows[b0:b0 + n] += 1
    assert (rows == 1).all()
    sizes = [n for _, n, _ in chunks]
    assert max(sizes) - min(sizes) <= 1
    try:
        whole = cuda_scan.scan_plan(b, h, r, SMS, elsize)
    except ValueError:
        # the fewest chunks: one fewer leaves some chunk without a plan
        n = len(chunks) - 1
        assert n >= 1
        with pytest.raises(ValueError):
            for i in range(n):
                cuda_scan.scan_plan((i + 1) * b // n - i * b // n, h, r, SMS, elsize)
    else:
        assert chunks == ((0, b, whole),)  # every batch with a plan keeps it


def test_chunks_of_the_lm_layer_at_the_batches_past_the_fault():
    assert [n for _, n, _ in cuda_scan.scan_chunks(657, 650, 300)] == [328, 329]
    assert [n for _, n, _ in cuda_scan.scan_chunks(1024, 650, 300)] == [512, 512]
    assert len(cuda_scan.scan_chunks(1024, 650, 300, SMS, 2)) == 2
    assert len(cuda_scan.scan_chunks(477, 650, 0)) == 2


def test_chunks_stream_where_not_even_one_row_is_resident():
    # fault 11: a dense h=2000 U (64 MB) fits in the shared memory of no
    # grouping; the batch stays one chunk, whose plan streams the rest
    (chunk,) = cuda_scan.scan_chunks(4, 2000, 0)
    assert chunk[:2] == (0, 4) and chunk[2].streamed and chunk[2].groups == 1


# a small layer on a one-SM plan, whose last batch with a plan is 64
# (low-rank) or 44 (dense): B=70 runs in two chunks; with bf16 weights, on
# the tensor-core walk's layout (ScanPlan.mma), 72 in both forms: B=80
T, B, F, H, RX, R, CHUNK_SMS = 3, 70, 16, 64, 4, 8, 1
BF16_B = 80


def make_inputs(rx, r, b=B, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    arrs = (n(T, b, F, scale=1.0), n(F, rx or 4 * H), n(rx, 4 * H) if rx else None, n(4, H),
            n(4 * H), n(H, r or 4 * H), n(r, 4 * H) if r else None, n(4 * H), n(b, H), n(b, H))
    return arrs, [None if a is None else torch.from_numpy(a) for a in arrs]


@pytest.fixture
def chunked(monkeypatch):
    """The scan entries as they run on the card, on CPU tensors: one chunk
    of rows a launch on a one-SM plan, each launch a stand-in that checks
    the chunk against its plan and returns the plain version on its rows.
    -> the list of (entry, rows) launched."""
    launched = []
    plain = {
        "_xin_fwd_launch": lambda bf16, *a: cuda_scan.lstm_scan_fused_xin_plain(
            *a, "bf16" if bf16 else "f32"),
        "_xin_res_launch": lambda bf16, res, save, *a: cuda_scan.lstm_scan_xin_fwd_res_plain(
            *a, "bf16" if bf16 else "f32", res, save),
        "_xin_bwd_launch": lambda bf16, *a: cuda_scan.lstm_scan_xin_bwd_plain(
            *a[:16], bias=a[16], precision="bf16" if bf16 else "f32"),
        "_gi_fwd_launch": lambda bf16, *a: cuda_scan.lstm_scan_fused_plain(
            *a, "bf16" if bf16 else "f32"),
        "_gi_res_launch": lambda bf16, res, *a: cuda_scan.lstm_recurrence_plain(
            *a, "bf16" if bf16 else "f32", res),
        "_gi_bwd_launch": lambda bf16, *a: cuda_scan.lstm_scan_bwd_plain(
            *a, "bf16" if bf16 else "f32"),
    }

    def stand_in(name, *args):
        n_opts = {"_xin_res_launch": 3, "_gi_res_launch": 2}.get(name, 1)
        opts, plan, tensors = args[:n_opts], args[n_opts], args[n_opts + 1:]
        rows = next(a for a in tensors if a is not None and a.dim() == 3).shape[1]
        assert plan.b == rows and all(a is None or a.is_contiguous() for a in tensors)
        launched.append((name, rows))
        return plain[name](*opts, *tensors)

    for name in plain:
        monkeypatch.setattr(cuda_scan, name, functools.partial(stand_in, name))
    monkeypatch.setattr(cuda_scan, "_on_cpu", lambda tensors: False)
    monkeypatch.setattr(cuda_scan, "_require_cuda", lambda name, xs: None)
    monkeypatch.setattr(cuda_scan, "_chunks_for", lambda b, h, r, device, bf16=False:
                        cuda_scan.scan_chunks(b, h, r, CHUNK_SMS, 2 if bf16 else 4))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for fn in (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
               cuda_scan.lstm_scan_xin_bwd, cuda_scan.lstm_scan_fused,
               cuda_scan.lstm_scan_fused_res, cuda_scan.lstm_scan_bwd):
        monkeypatch.setattr(fn, "launches", 0)
    return launched


def assert_all_close(gots, wants, tol):
    assert len(gots) == len(wants)
    for i, (g, w) in enumerate(zip(gots, wants)):
        assert (g is None) == (w is None), i
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, i
            torch.testing.assert_close(g.float(), w.float(), msg=f"output {i}", **tol)


def test_the_small_layer_runs_in_two_chunks():
    assert [n for _, n, _ in cuda_scan.scan_chunks(B, H, R, CHUNK_SMS)] == [35, 35]
    assert [n for _, n, _ in cuda_scan.scan_chunks(B, H, 0, CHUNK_SMS)] == [35, 35]
    assert len(cuda_scan.scan_chunks(64, H, R, CHUNK_SMS)) == 1


# (rx, r, precision, residuals, save_gates): low-rank, dense recurrence,
# dense both sides; bf16 products; bf16 residuals; the recompute policy
VARIANTS = {
    "lowrank": (RX, R, "f32", "f32", True),
    "dense_rec": (RX, 0, "f32", "f32", True),
    "dense_both": (0, 0, "f32", "f32", True),
    "bf16": (RX, R, "bf16", "f32", True),
    "bf16_res": (RX, R, "f32", "bf16", True),
    "recompute": (RX, R, "f32", "f32", False),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_x_mode_entries_in_chunks_give_the_whole_batch_s_plain_results(chunked, name):
    rx, r, precision, residuals, save = VARIANTS[name]
    bf16 = precision == "bf16"
    b = BF16_B if bf16 else B
    _, args = make_inputs(rx, r, b=b)
    tol, grad_tol = (BF16_TOL, BF16_GRAD_TOL) if bf16 or residuals == "bf16" else (
        FWD_TOL, GRAD_TOL)
    got = cuda_scan.lstm_scan_fused_xin(*args, precision)
    assert_all_close(got, cuda_scan.lstm_scan_fused_xin_plain(*args, precision), tol)

    res = cuda_scan.lstm_scan_fused_xin_res(*args, precision, residuals, save)
    res_p = cuda_scan.lstm_scan_xin_fwd_res_plain(*args, precision, residuals, save)
    assert_all_close(res, res_p, tol)

    rng = np.random.default_rng(5)
    dys = torch.from_numpy(rng.standard_normal((T, b, H)).astype(np.float32))
    dc_last = torch.from_numpy(rng.standard_normal((b, H)).astype(np.float32))
    bias = None if save else args[4]
    saved = (*args[:4], *args[5:], *res_p)
    grads = cuda_scan.lstm_scan_xin_bwd(*saved, dys, dc_last, bias, precision)
    want = cuda_scan.lstm_scan_xin_bwd_plain(*saved, dys, dc_last, bias=bias,
                                             precision=precision)
    assert_all_close(grads, want, grad_tol)
    assert [n for _, n in chunked] == [b // 2, b - b // 2] * 3
    for fn in (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
               cuda_scan.lstm_scan_xin_bwd):
        assert fn.launches == 2  # one a chunk


@pytest.mark.parametrize("name", ["lowrank", "dense_rec", "bf16", "bf16_res"])
def test_gi_mode_entries_in_chunks_give_the_whole_batch_s_plain_results(chunked, name):
    _, r, precision, residuals, _ = VARIANTS[name]
    bf16 = precision == "bf16"
    b = BF16_B if bf16 else B
    _, args = make_inputs(RX, r, b=b)
    tol, grad_tol = (BF16_TOL, BF16_GRAD_TOL) if bf16 or residuals == "bf16" else (
        FWD_TOL, GRAD_TOL)
    gi = torch.from_numpy(np.random.default_rng(2).standard_normal((T, b, 4 * H))
                          .astype(np.float32))
    rec = (gi, *args[5:])
    got = cuda_scan.lstm_scan_fused(*rec, precision)
    assert_all_close(got, cuda_scan.lstm_scan_fused_plain(*rec, precision), tol)
    res = cuda_scan.lstm_scan_fused_res(*rec, precision, residuals)
    res_p = cuda_scan.lstm_recurrence_plain(*rec, precision, residuals)
    assert_all_close(res, res_p, tol)
    dys = torch.from_numpy(np.random.default_rng(5).standard_normal((T, b, H))
                           .astype(np.float32))
    grads = cuda_scan.lstm_scan_bwd(*args[5:], *res_p, dys, None, precision)
    assert_all_close(grads, cuda_scan.lstm_scan_bwd_plain(*args[5:], *res_p, dys, None,
                                                          precision), grad_tol)
    assert [n for _, n in chunked] == [b // 2, b - b // 2] * 3
    for fn in (cuda_scan.lstm_scan_fused, cuda_scan.lstm_scan_fused_res,
               cuda_scan.lstm_scan_bwd):
        assert fn.launches == 2


def test_one_chunk_is_one_launch_on_the_caller_s_tensors(chunked):
    _, args = make_inputs(RX, R, b=64)
    cuda_scan.lstm_scan_fused_xin(*args)
    assert chunked == [("_xin_fwd_launch", 64)]
    assert cuda_scan.lstm_scan_fused_xin.launches == 1


def test_chunked_scan_and_its_vjp_match_the_jax_kernel(chunked):
    arrs, args = make_inputs(RX, R)
    rng = np.random.default_rng(3)
    dys, dc_last = rng.standard_normal((T, B, H)), rng.standard_normal((B, H))
    ys, c_last = cuda_scan.LSTMScanXin.apply(*[None if a is None else a.requires_grad_()
                                               for a in args])
    torch.autograd.backward((ys, c_last), (torch.from_numpy(dys).float(),
                                           torch.from_numpy(dc_last).float()))
    (ys_j, c_j), vjp = jax.vjp(lambda *a: jax_scan(*a, interpret=True),
                               *[None if a is None else jnp.asarray(a) for a in arrs])
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    np.testing.assert_allclose(c_last.detach().numpy(), np.asarray(c_j), **FWD_TOL)
    want = vjp((jnp.asarray(dys, jnp.float32), jnp.asarray(dc_last, jnp.float32)))
    for i, (a, w) in enumerate(zip(args, want)):
        if a is not None:
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(w).reshape(a.shape),
                                       err_msg=f"input {i}", **GRAD_TOL)
    assert [n for _, n in chunked] == [35, 35, 35, 35]  # residual forward, then BPTT
