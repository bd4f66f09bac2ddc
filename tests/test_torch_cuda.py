"""The port's CUDA kernels on the card: each kernel against its plain PyTorch
version on the same inputs. These tests skip where there is no CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
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

# (T, B, F, h, rx, r): ragged edges everywhere, F = h, F < h (HAR), F > h
CASES = {
    "f_eq_h": (5, 3, 16, 16, 4, 4),
    "har": (24, 81, 77, 180, 8, 6),
    "f_gt_h": (7, 9, 70, 33, 5, 40),
    "wide": (3, 6, 1600, 1600, 65, 129),  # over 48 KB of shared memory
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(t, b, f, h, rx, r, device, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(device)

    return (n(t, b, f, scale=1.0), n(f, rx, scale=f ** -0.5), n(rx, 4 * h, scale=rx ** -0.5),
            n(4, h, scale=0.1), n(4 * h, scale=0.1), n(h, r, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5), n(4 * h, scale=0.1), n(b, h, scale=0.5),
            n(b, h, scale=0.5))


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
