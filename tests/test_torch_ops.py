"""The port's fused LSTM scan (`vmlmf_tpu_torch.ops.cuda_scan`) against the
JAX package's `lstm_scan_fused_xin`, run in Pallas interpret mode on the CPU.

On CPU tensors the port's wrapper runs its plain version, so these tests hold
that version to the TPU kernel's function at the f32 forward tolerance of
tests/test_pallas.py. The CUDA kernel itself is held to the plain version in
tests/test_torch_cuda.py, which runs only where a CUDA device exists.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.ops.pallas_scan import lstm_scan_fused_xin as jax_scan  # noqa: E402
from vmlmf_tpu_torch.ops import _build, cuda_scan  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)

# (T, B, F, h, rx, r): F = h (the LM), F < h (HAR-like), F > h, and B, T
# that are not multiples of 8.
CASES = {
    "f_eq_h": (5, 3, 16, 16, 4, 4),
    "f_lt_h": (6, 5, 9, 20, 3, 5),
    "f_gt_h": (7, 9, 24, 12, 5, 3),
    "ragged": (9, 11, 13, 13, 6, 7),
}


def make_inputs(t, b, f, h, rx, r, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return (n(t, b, f, scale=1.0), n(f, rx), n(rx, 4 * h), n(4, h), n(4 * h),
            n(h, r), n(r, 4 * h), n(4 * h), n(b, h), n(b, h))


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_matches_jax_kernel(case):
    arrs = make_inputs(*CASES[case])
    ys_j, c_j = jax_scan(*map(jnp.asarray, arrs), interpret=True)
    before = cuda_scan.lstm_scan_fused_xin.launches
    ys_t, c_t = cuda_scan.lstm_scan_fused_xin(*map(torch.from_numpy, arrs))
    assert cuda_scan.lstm_scan_fused_xin.launches == before  # CPU: no kernel
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), **TOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)


def meta_inputs(**override):
    args = dict(zip(cuda_scan._ARG_NAMES,
                    (torch.from_numpy(a).to("meta") for a in make_inputs(*CASES["ragged"]))))
    args.update(override)
    return [args[k] for k in cuda_scan._ARG_NAMES]


def test_non_cpu_tensors_never_take_the_plain_version():
    # meta tensors pass every check but are not CUDA tensors: the wrapper
    # raises instead of running the plain version
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_scan.lstm_scan_fused_xin(*meta_inputs())


@pytest.mark.parametrize("bad,err", [
    (dict(vx=torch.empty(6, 51, device="meta")), ValueError),
    (dict(bias=torch.empty(52, dtype=torch.float64, device="meta")), TypeError),
    (dict(u=torch.empty(7, 13, device="meta").T), ValueError),
    (dict(h0=torch.empty(11, 13)), ValueError),
], ids=["shape", "dtype", "contiguity", "mixed_devices"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err, match=next(iter(bad))):
        cuda_scan.lstm_scan_fused_xin(*meta_inputs(**bad))


def test_scan_cost_counts_each_input_and_output_once():
    t, b, f, h, rx, r = CASES["f_lt_h"]
    arrs = make_inputs(t, b, f, h, rx, r)
    outputs = t * b * h + b * h
    ops, nbytes = cuda_scan.scan_cost(t, b, f, rx, h, r)
    assert nbytes == 4 * (sum(a.size for a in arrs) + outputs)
    assert ops > 2 * t * b * (f * rx + rx * 4 * h + h * r + r * 4 * h)


def test_build_names_every_source_and_needs_nvcc(monkeypatch, tmp_path):
    assert "lstm_scan_xin_fwd" in _build.sources()
    path = _build.library_path("lstm_scan_xin_fwd")
    assert path.parent == _build.BUILD_DIR and path.name.endswith(".so")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.nvcc_path()
