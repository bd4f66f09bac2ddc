"""The port's host side against the JAX package's, on the CPU: data loaders
and preparation (sliding windows, the Opportunity pipeline, the UCI-HAR
loader, the native library and its NumPy versions), checkpoints, the
compression analytics and the roofline report, timers and profiling
hooks, prefetching, and the cell and RNN conveniences. Every file a test
reads, it writes itself; nothing is fetched.
"""

import importlib
import io
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu import config as jconfig  # noqa: E402
from vmlmf_tpu.cells import GRUCell as JaxGRUCell  # noqa: E402
from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.data import _native as j_native  # noqa: E402
from vmlmf_tpu.data import batching as jbatching  # noqa: E402
from vmlmf_tpu.data import download as jdownload  # noqa: E402
from vmlmf_tpu.data import har as jhar  # noqa: E402
from vmlmf_tpu.data import opp_preprocess as jopp  # noqa: E402
from vmlmf_tpu.nn.recurrence import RNN as JaxRNN  # noqa: E402
from vmlmf_tpu.train import checkpoint as jckpt  # noqa: E402
from vmlmf_tpu.utils import analytics as janalytics  # noqa: E402
from vmlmf_tpu_torch import config  # noqa: E402
from vmlmf_tpu_torch.cells import GRUCell, VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.data import _native, batching, download, har, opp_preprocess  # noqa: E402
from vmlmf_tpu_torch.data import sliding_window as sw  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import RNN  # noqa: E402
from vmlmf_tpu_torch.train import checkpoint  # noqa: E402
from vmlmf_tpu_torch.utils import analytics, profiling, timer  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

FWD_TOL = dict(atol=2e-5, rtol=2e-5)  # f32 (tests/test_pallas.py:57)
# the module: vmlmf_tpu.data exports a function of the same name
jsw = importlib.import_module("vmlmf_tpu.data.sliding_window")


@pytest.fixture(params=["native", "numpy"])
def native_or_numpy(request, monkeypatch):
    """Each test twice: with the native library where it loads, and with
    VMLMF_NO_NATIVE=1 (the NumPy versions)."""
    if request.param == "numpy":
        monkeypatch.setenv("VMLMF_NO_NATIVE", "1")
    return request.param


# -- sliding windows

@pytest.mark.parametrize("n,f,w,s", [(100, 77, 24, 12), (24, 3, 24, 12), (23, 3, 24, 12),
                                     (128, 9, 128, 64), (50, 2, 5, 1)])
def test_sliding_window_matches_jax(native_or_numpy, n, f, w, s):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, 18, n).astype(np.int32)
    want = jsw.sliding_window(x, w, s)
    np.testing.assert_array_equal(sw.sliding_window(x, w, s), want)
    np.testing.assert_array_equal(_native.sliding_window_f32(x, w, s), want)
    for got, ref in zip(sw.window_series(x, y, w, s), jsw.window_series(x, y, w, s)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,ws,ss,flatten", [((10,), 3, None, True), ((7, 9), (2, 3), (1, 2),
                                                                         True),
                                                 ((6, 5, 4), (3, 5, 2), (3, 1, 2), False),
                                                 ((8, 8), 4, 4, False)])
def test_sliding_window_nd_matches_jax(shape, ws, ss, flatten):
    a = np.arange(np.prod(shape)).reshape(shape)
    ws = ws if isinstance(ws, tuple) else (ws,) * len(shape)
    ss = ss if ss is None or isinstance(ss, tuple) else (ss,) * len(shape)
    np.testing.assert_array_equal(sw.sliding_window_nd(a, ws, ss, flatten),
                                  jsw.sliding_window_nd(a, ws, ss, flatten))
    assert sw.norm_shape(3) == jsw.norm_shape(3) == (3,)
    assert sw.norm_shape([2, 3]) == jsw.norm_shape([2, 3])
    with pytest.raises(ValueError, match="same length"):
        sw.sliding_window_nd(a, (2,) * (len(shape) + 1))
    with pytest.raises(TypeError):
        sw.norm_shape("x")


# -- the native library against its NumPy versions and the JAX package's

def test_native_parses_and_gathers_as_the_jax_package(native_or_numpy):
    rng = np.random.default_rng(0)
    m = rng.standard_normal((50, 7)) * np.power(10.0, rng.integers(-8, 8, (50, 7)))
    m[rng.random((50, 7)) < 0.1] = np.nan
    txt = "\n".join(" ".join(f"{v:.10g}" for v in row) for row in m).encode()
    np.testing.assert_allclose(_native.loadtxt(txt), np.loadtxt(io.BytesIO(txt)), rtol=1e-14,
                               equal_nan=True)
    np.testing.assert_allclose(_native.loadtxt(txt), j_native.loadtxt(txt), rtol=1e-14,
                               equal_nan=True)
    assert _native.loadtxt(b"1 2 3\n").shape == (3,)
    src = rng.standard_normal((100, 24, 77)).astype(np.float32)
    idx = rng.permutation(100)[:81]
    np.testing.assert_array_equal(_native.gather_rows(src, idx), src[idx])
    labels = rng.integers(0, 18, (100, 1)).astype(np.int32)
    np.testing.assert_array_equal(_native.gather_rows(labels, idx), labels[idx])


def test_native_interpolates_and_normalizes_as_the_jax_package(native_or_numpy):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 11)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[:5, 0], x[-5:, 1], x[:, 2] = np.nan, np.nan, np.nan  # leading, trailing, all NaN
    np.testing.assert_allclose(_native.interp_nan_f32(x), jopp.interpolate_nan(x), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(opp_preprocess.interpolate_nan(x), jopp.interpolate_nan(x))
    z = (rng.standard_normal((64, 77)) * 4000).astype(np.float32)
    mn, mx = np.asarray(jopp.NORM_MIN, np.float32), np.asarray(jopp.NORM_MAX, np.float32)
    np.testing.assert_allclose(_native.norm_clamp_f32(z, mn, mx), jopp.normalize(z),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(opp_preprocess.normalize(z), jopp.normalize(z))


def test_native_falls_back_under_the_switch(monkeypatch):
    monkeypatch.setenv("VMLMF_NO_NATIVE", "1")
    assert _native.get_lib() is None


# -- the Opportunity pipeline

def raw_opp(rows, seed):
    """A raw .dat matrix [rows, 250]: sensor noise, NaNs, the locomotion
    (raw column 243) and gesture (249) labels."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(scale=2000.0, size=(rows, 250))
    raw[:, 243] = rng.choice([0, 1, 2, 4, 5], rows)
    raw[:, 249] = rng.choice([0, 406516, 404505, 408512, 405506], rows)
    raw[rng.random((rows, 250)) < 0.02] = np.nan
    raw[:, 243][np.isnan(raw[:, 243])] = 0
    raw[:, 249][np.isnan(raw[:, 249])] = 0
    return raw


@pytest.mark.parametrize("channels,task", [(77, "gestures"), (113, "gestures"),
                                           (113, "locomotion")])
def test_process_file_matches_jax(native_or_numpy, channels, task):
    raw = raw_opp(300, channels)
    x, y = opp_preprocess.process_file(raw.copy(), task, channels)
    xj, yj = jopp.process_file(raw.copy(), task, channels)
    assert x.shape[1] == channels and x.dtype == xj.dtype and y.dtype == yj.dtype
    np.testing.assert_allclose(x, xj, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(y, yj)
    with pytest.raises(ValueError, match="77 or 113"):
        opp_preprocess.process_file(raw, task, 100)


def write_opp_zip(path, rows=120):
    with zipfile.ZipFile(path, "w") as zf:
        for i, name in enumerate(("S1-Drill.dat", "S1-ADL1.dat", "S2-ADL4.dat", "S3-ADL5.dat")):
            buf = io.StringIO()
            np.savetxt(buf, raw_opp(rows, 10 + i), fmt="%.6g")
            zf.writestr(f"OpportunityUCIDataset/dataset/{name}", buf.getvalue())


@pytest.mark.parametrize("channels,task", [(77, "gestures"), (113, "locomotion")])
def test_generate_npy_and_load_opp_match_jax(tmp_path, channels, task):
    zpath = tmp_path / "OpportunityUCIDataset.zip"
    write_opp_zip(zpath)
    ours = opp_preprocess.generate_npy(str(zpath), str(tmp_path / "port"), task, channels)
    theirs = jopp.generate_npy(str(zpath), str(tmp_path / "jax"), task, channels)
    got, want = har.load_opp(ours), jhar.load_opp(theirs)
    assert got[0].shape[1:] == (24, channels)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    x_tr, _, _, _ = har.load_or_synthesize("opp", ours)
    np.testing.assert_array_equal(x_tr, got[0])


def test_load_uci_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    for mode, n in (("train", 5), ("test", 3)):
        sig = tmp_path / mode / "Inertial Signals"
        sig.mkdir(parents=True)
        for s in har.UCI_SIGNALS:
            np.savetxt(sig / f"{s}{mode}.txt", rng.standard_normal((n, 128)), fmt="%.8e")
        (tmp_path / mode / f"y_{mode}.txt").write_text("".join(f"{k}\n" for k in
                                                               rng.integers(1, 7, n)))
    got, want = har.load_uci(str(tmp_path)), jhar.load_uci(str(tmp_path))
    assert got[0].shape == (5, 128, 9) and got[2].shape == (3, 128, 9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].min() >= 0  # 0-based
    assert har.load_or_synthesize("uci", str(tmp_path))[0].shape == (5, 128, 9)
    # a folder without the files: synthetic windows of the real shapes
    empty = tmp_path / "empty"
    empty.mkdir()
    for a, b in zip(har.load_or_synthesize("uci", str(empty), seed=1),
                    jhar.load_or_synthesize("uci", str(empty), seed=1)):
        np.testing.assert_array_equal(a, b)


# -- download: the existing-file and error paths only

def test_download_takes_a_zip_already_there(tmp_path):
    zpath = tmp_path / "UCI HAR Dataset.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr("UCI HAR Dataset/README.txt", "readme")
    assert download.download("uci", str(tmp_path)) == jdownload.download("uci", str(tmp_path),
                                                                          extract=False)
    assert (tmp_path / "UCI HAR Dataset" / "README.txt").read_text() == "readme"
    assert download.DATASETS == jdownload.DATASETS


def test_download_names_the_file_to_place_when_the_fetch_fails(tmp_path, monkeypatch):
    import urllib.request

    def refuse(url, path):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    with pytest.raises(RuntimeError, match="OpportunityUCIDataset.zip"):
        download.download("opp", str(tmp_path))
    with pytest.raises(RuntimeError, match="--synthetic"):
        download.prepare_opp(str(tmp_path), str(tmp_path / "npy"))
    with pytest.raises(KeyError):
        download.download("nope", str(tmp_path))


# -- checkpoints

def test_checkpoint_stores_leaves_in_jax_flatten_order(tmp_path):
    # insertion order differs from sorted order, and two leaves share a shape
    tree = {"z": torch.arange(4.0), "a": [torch.ones(2, 2), {"y": torch.zeros(4), "b": None,
                                                              "c": torch.full((4,), 2.0)}]}
    path = checkpoint.save_checkpoint(str(tmp_path / "ck"), tree, meta={"k": 1})
    flat = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, {
        "z": np.arange(4.0), "a": [np.ones((2, 2)), {"y": np.zeros(4), "b": None,
                                                     "c": np.full(4, 2.0)}]}))
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, leaf in enumerate(flat):
            np.testing.assert_array_equal(z[f"a{i}"], leaf)
    back = checkpoint.load_checkpoint(path, tree)
    assert list(back) == ["z", "a"] and list(back["a"][1]) == ["y", "b", "c"]
    for got, want in zip(checkpoint.flatten(back)[0], checkpoint.flatten(tree)[0]):
        torch.testing.assert_close(got, want)
    assert checkpoint.checkpoint_meta(path) == jckpt.checkpoint_meta(path) == {"k": 1}
    # the JAX loader reads it into the same tree of arrays
    like = {"z": np.zeros(4), "a": [np.zeros((2, 2)), {"y": np.zeros(4), "b": None,
                                                       "c": np.zeros(4)}]}
    jback = jckpt.load_checkpoint(path, like)
    np.testing.assert_array_equal(jback["a"][1]["c"], np.full(4, 2.0))
    np.testing.assert_array_equal(jback["a"][1]["y"], np.zeros(4))


def test_checkpoint_refuses_another_shape_as_jax_does(tmp_path):
    path = checkpoint.save_checkpoint(str(tmp_path / "ck"), {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="checkpoint leaf 0 shape"):
        checkpoint.load_checkpoint(path, {"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="checkpoint leaf 0 shape"):
        jckpt.load_checkpoint(path, {"w": np.zeros((4, 3))})


def test_run_name_matches_jax():
    for kw in (dict(), dict(layer_sizes=(180,), w_rank=8, u_ranks=(6,), data="OPP", seed=3),
               dict(layer_sizes=[64, 64], u_ranks=[12, 6], data="uci", seed=0),
               dict(w_rank=300, u_ranks=300)):
        assert checkpoint.run_name("vmmodel", **kw) == jckpt.run_name("vmmodel", **kw)


# -- analytics

# every model name of tests/test_cli.py, with its u ranks
CLI_MODELS = [("mylstm", (6,)), ("vmmodel", (6,)), ("vmlmf", (6,)), ("vmmodel_group2", (2, 4)),
              ("vmlmf_group2", (2, 4)), ("vmgroup_novm", (2, 4)), ("mylstm_group", (12, 6)),
              ("mygru", (6,)), ("mygru_group", (2, 4)), ("dualdiag", (6,)), ("diag", None)]


@pytest.mark.parametrize("name,u_ranks", CLI_MODELS)
def test_analytics_count_as_the_jax_package(name, u_ranks):
    w = None if u_ranks is None else 8
    kw = dict(model=name, w_rank=w, u_ranks=u_ranks, layer_sizes=(180,))
    jparams = jconfig.HARConfig(**kw, backend="xla").build_model().init(jax.random.PRNGKey(0))
    params = config.HARConfig(**kw).build_model().init(torch.Generator().manual_seed(0), "cpu")
    assert analytics.count_params(params) == janalytics.count_params(jparams)
    assert analytics.count_params(jax.tree_util.tree_map(np.asarray, jparams)) == \
        janalytics.count_params(jparams)
    for vm in (True, False):
        args = (77, (180,), 24, 81)
        fkw = dict(w_rank=w, u_rank=u_ranks, vm=vm and w is not None)
        assert analytics.model_flops(*args, **fkw) == janalytics.model_flops(*args, **fkw)
    assert analytics.lstm_cell_flops(77, 180, w, u_ranks) == \
        janalytics.lstm_cell_flops(77, 180, w, u_ranks)
    assert analytics.vmlmf_hw_flops(77, 180, 8, 6, 3) == janalytics.vmlmf_hw_flops(77, 180, 8, 6, 3)
    rep = (analytics.compression_report(10, 4, baseline_flops=9, compressed_flops=3),
           janalytics.compression_report(10, 4, baseline_flops=9, compressed_flops=3))
    assert rep[0] == rep[1]


def test_roofline_report_on_the_h100():
    assert analytics.detect_chip("NVIDIA H100 80GB HBM3") == "h100"
    peaks = analytics.chip_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16": 989e12, "f32": 67e12, "hbm_bw": 3.35e12}
    rep = analytics.roofline_report(67e9, 3.35e9, 2e-3, chip="h100")
    assert rep["bound"] == "compute"  # intensity 20 at a ridge of 20
    assert rep["roofline_seconds"] == pytest.approx(1e-3)
    assert rep["fraction_of_roofline"] == pytest.approx(0.5)
    assert rep["achieved_flops_per_s"] == pytest.approx(33.5e12)
    mem = analytics.roofline_report(1e9, 3.35e9, 2e-3, chip="h100", dtype="bf16")
    assert mem["bound"] == "memory" and mem["ridge_intensity"] == pytest.approx(989 / 3.35)


def test_roofline_raises_on_a_card_it_does_not_know(monkeypatch):
    monkeypatch.delenv("VMLMF_GPU_PEAKS", raising=False)
    with pytest.raises(ValueError, match="VMLMF_GPU_PEAKS"):
        analytics.roofline_report(1e9, 1e9, 1.0, chip="NVIDIA A100-SXM4-80GB")
    monkeypatch.setenv("VMLMF_GPU_PEAKS", "bf16:312e12")
    with pytest.raises(ValueError, match="no peaks for the card 'nvidia a100-sxm4-80gb'"):
        analytics.chip_peaks("NVIDIA A100-SXM4-80GB")
    monkeypatch.setenv("VMLMF_GPU_PEAKS", "bf16:312e12,f32:19.5e12,hbm_bw:2.0e12")
    assert analytics.chip_peaks("NVIDIA A100-SXM4-80GB")["hbm_bw"] == 2.0e12
    assert analytics.chip_peaks("h100")["f32"] == 19.5e12  # over the table's
    monkeypatch.setenv("VMLMF_GPU_PEAKS", "tf32:1")
    with pytest.raises(ValueError, match="not in"):
        analytics.chip_peaks("h100")


# -- timers, profiling, prefetching

def test_timer_and_device_time_on_the_cpu():
    t = timer.Timer().tic()
    assert t.toc() >= 0 and len(t.laps) == 1 and t.total == t.laps[0]
    calls = []
    dt = timer.device_time(lambda a: calls.append(a), 1, iters=3, warmup=2, device="cpu")
    assert dt >= 0 and len(calls) == 5


def test_trace_writes_a_chrome_trace_and_nan_checks_toggle(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace.json").exists() and len(prof.key_averages()) > 0
    profiling.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_prefetch_yields_every_batch_in_order_on_the_cpu():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10, dtype=np.int32)
    base = list(batching.batch_iterator(x, y, 3, shuffle=False, drop_last=False))
    pre = list(batching.prefetch_to_device(
        batching.batch_iterator(x, y, 3, shuffle=False, drop_last=False), size=2, device="cpu"))
    jpre = list(jbatching.prefetch_to_device(
        jbatching.batch_iterator(x, y, 3, shuffle=False, drop_last=False), size=2))
    assert len(pre) == len(base) == len(jpre) == 4
    for (xb, yb), (xp, yp), (xj, yj) in zip(base, pre, jpre):
        assert isinstance(xp, torch.Tensor) and xp.device.type == "cpu"
        np.testing.assert_array_equal(xp.numpy(), xb)
        np.testing.assert_array_equal(yp.numpy(), np.asarray(yj))
    assert isinstance(pre[0], tuple)
    lists = list(batching.prefetch_to_device(iter([[x[:2], y[:2]]]), device="cpu"))
    assert isinstance(lists[0], list) and lists[0][0].shape == (2, 4)


# -- the cell and RNN conveniences

def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("make", ["vmlmf", "gru"])
def test_cell_conveniences_match_jax(make):
    if make == "vmlmf":
        jcell, cell = JaxVMLMFCell(6, 8, w_rank=3, u_rank=2), VMLMFCell(6, 8, w_rank=3, u_rank=2)
    else:
        jcell, cell = JaxGRUCell(6, 8, w_rank=3, u_rank=2), GRUCell(6, 8, w_rank=3, u_rank=2)
    assert cell.num_gates == jcell.num_gates == (4 if make == "vmlmf" else 3)
    jparams = jcell.init(jax.random.PRNGKey(0))
    params = params_from_jax(to_np(jparams), device="cpu")
    assert cell.param_count(params) == jcell.param_count(jparams)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    jstate = jax.tree_util.tree_map(lambda a: a + 0.1, jcell.state0(5))
    state = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), to_np(jstate))
    (s, h) = cell.apply_step(params, torch.from_numpy(x), state)
    (sj, hj) = jcell.apply_step(jparams, jnp.asarray(x), jstate)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **FWD_TOL)
    np.testing.assert_allclose(cell.out_of(s).numpy(), np.asarray(jcell.out_of(sj)), **FWD_TOL)


def test_last_hidden_concat_matches_jax():
    jrnn = JaxRNN((JaxVMLMFCell(6, 8, w_rank=3, u_rank=2), JaxGRUCell(8, 5)), backend="xla")
    rnn = RNN((VMLMFCell(6, 8, w_rank=3, u_rank=2), GRUCell(8, 5)), backend="loop")
    jparams = jrnn.init(jax.random.PRNGKey(1))
    params = params_from_jax(to_np(jparams), device="cpu")
    x = np.random.default_rng(2).standard_normal((3, 4, 6)).astype(np.float32)
    _, finals = rnn(params, torch.from_numpy(x))
    _, jfinals = jrnn(jparams, jnp.asarray(x))
    got = rnn.last_hidden_concat(finals)
    assert got.shape == (3, 13)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jrnn.last_hidden_concat(jfinals)),
                               **FWD_TOL)
