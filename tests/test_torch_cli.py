"""The port's CLIs (`vmlmf_tpu_torch.cli.har_main`, `lm_main`) and their
checkpoints against the JAX package's, on the CPU (``--device cpu``).

A checkpoint that the JAX CLI writes evaluates in the port's CLI to JAX's
accuracy and macro-F1; one that the port's CLI writes loads into the JAX
model and gives the port's logits. The compression report and the LM's
parameter banner print the JAX package's lines, and every flag keeps its
JAX default but the two documented departures, ``--backend`` (the port's
names, default "fused", the JAX names as aliases) and ``--device``.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from vmlmf_tpu import config as jconfig  # noqa: E402
from vmlmf_tpu.cli import har_main as jhar  # noqa: E402
from vmlmf_tpu.cli import lm_main as jlm  # noqa: E402
from vmlmf_tpu.train import checkpoint as jckpt  # noqa: E402
from vmlmf_tpu_torch import config  # noqa: E402
from vmlmf_tpu_torch.cli import har_main, lm_main  # noqa: E402
from vmlmf_tpu_torch.train import checkpoint  # noqa: E402

FWD_TOL = dict(atol=2e-5, rtol=2e-5)  # f32 logits (tests/test_pallas.py:57)
N_TEST = 200  # synthetic_har's test windows
SMALL = ["--synthetic", "--max_epochs", "1", "--layer_sizes", "16"]

# CLI flags of each model the round trips cover
MODELS = {
    "vmmodel": ["--model", "vmmodel", "--wRank", "4", "--uRanks", "4"],
    "vmlmf_group2": ["--model", "vmlmf_group2", "--wRank", "4", "--uRanks", "2", "4"],
    "mygru": ["--model", "mygru", "--wRank", "4", "--uRanks", "4"],
    "bidirectional": ["--model", "vmmodel", "--wRank", "4", "--uRanks", "4",
                      "--bidirectional"],
    "deepconv": ["--model", "mylstm", "--deepconv"],
}


def run(main, argv):
    """main(argv) -> (its result, what it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def har_config(argv, module):
    """The HARConfig (of ``module``, config or jconfig) the CLI builds."""
    args = (jhar if module is jconfig else har_main).get_args(argv)
    return module.HARConfig(
        model=args.model, layer_sizes=tuple(args.layer_sizes), w_rank=args.wRank,
        u_ranks=tuple(args.uRanks) if args.uRanks else None, groups=args.group,
        bidirectional=args.bidirectional, merge=args.concatingmode, deepconv=args.deepconv,
        data=args.data, channels=args.channels, batch_size=args.batch_size,
        backend="xla" if module is jconfig else "fused")


def ckpt_path(tmp_path, argv):
    args = har_main.get_args(argv)
    name = checkpoint.run_name(args.model, layer_sizes=args.layer_sizes, w_rank=args.wRank,
                               u_ranks=args.uRanks, data=args.data, seed=args.seed)
    return tmp_path / name


@pytest.mark.parametrize("model", ["vmmodel", "mygru"])
def test_jax_checkpoint_evaluates_to_jax_s_metrics_in_the_port_s_cli(tmp_path, model):
    argv = SMALL + MODELS[model] + ["--ckpt_dir", str(tmp_path)]
    want, _ = run(jhar.main, argv + ["--total", "--backend", "xla"])
    got, printed = run(har_main.main, argv + ["--device", "cpu"])
    assert "Test accuracy:: " in printed and "saved checkpoint" not in printed
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / N_TEST
    assert abs(got["macro_f1"] - want["macro_f1"]) <= 1 / N_TEST


@pytest.mark.parametrize("model", list(MODELS))
def test_port_checkpoint_loads_into_the_jax_model_with_equal_logits(tmp_path, model):
    argv = SMALL + MODELS[model] + ["--ckpt_dir", str(tmp_path)]
    result, printed = run(har_main.main, argv + ["-train", "--device", "cpu"])
    assert result is None and "saved checkpoint" in printed
    path = str(ckpt_path(tmp_path, argv))
    jmodel = har_config(argv, jconfig).build_model()
    jparams = jckpt.load_checkpoint(path, jmodel.init(jax.random.PRNGKey(0)))
    pmodel = har_config(argv, config).build_model()
    params = checkpoint.load_checkpoint(path, pmodel.init(torch.Generator().manual_seed(1),
                                                          "cpu"))
    x = np.random.default_rng(0).standard_normal((5, 24, 77)).astype(np.float32)
    with torch.no_grad():
        got = pmodel.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jparams, x)), **FWD_TOL)
    # the port's checkpoint is the JAX package's layout: its leaves in flatten order
    flat = jax.tree_util.tree_leaves(jparams)
    assert checkpoint.checkpoint_meta(path)["config"]["model"] == har_main.get_args(argv).model
    with np.load(f"{path}/arrays.npz") as z:
        assert len(z.files) == len(flat)
        for i, leaf in enumerate(flat):
            np.testing.assert_array_equal(z[f"a{i}"], np.asarray(leaf))


@pytest.mark.parametrize("model", ["mylstm", "vmmodel", "vmlmf_group2", "mygru"])
def test_report_prints_jax_s_lines(model):
    argv = SMALL + (MODELS.get(model) or ["--model", model])
    jcfg, cfg = har_config(argv, jconfig), har_config(argv, config)
    jparams = jcfg.build_model().init(jax.random.PRNGKey(0))
    params = cfg.build_model().init(torch.Generator().manual_seed(0), "cpu")
    _, want = run(lambda _: jhar._report(jcfg, jparams, 24), None)
    _, got = run(lambda _: har_main._report(cfg, params, 24, "cpu"), None)
    assert got == want and "Number of FLOPs" in got


def test_lm_main_prints_jax_s_banner_and_trains():
    argv = ["--synthetic", "--total_epochs", "1", "--hidden_size", "32", "--layer_num", "1",
            "--batch_size", "20", "--seq_length", "35", "--vocab_size", "64", "--wRank", "8",
            "--uRanks", "8"]
    _, want = run(jlm.main, argv)
    history, got = run(lm_main.main, argv + ["--device", "cpu"])
    banner = [line for line in want.splitlines() if line.startswith("*parameters")]
    assert len(banner) == 1 and banner[0] in got.splitlines()
    assert np.isfinite(history[0]["val_ppl"]) and np.isfinite(history[-1]["test_ppl"])
    assert "Validation set perplexity" in got


def test_every_flag_keeps_jax_s_default_but_backend_and_device():
    for jax_main, port_main in ((jhar, har_main), (jlm, lm_main)):
        want, got = vars(jax_main.get_args([])), vars(port_main.get_args([]))
        assert set(got) == set(want) | {"device"}
        assert want["backend"] == "xla" and got["backend"] == "fused" and got["device"] == "cuda"
        for key in want:
            if key != "backend":
                assert got[key] == want[key], key
        # the JAX backend names are aliases of the port's
        for name, ours in (("xla", "loop"), ("pallas", "fused"),
                           ("pallas_pipelined", "fused_pipelined"), ("pipelined", "pipelined"),
                           ("fused", "fused"), ("loop", "loop")):
            assert port_main.get_args(["--backend", name]).backend == ours
        with pytest.raises(SystemExit):
            port_main.get_args(["--backend", "nope"])


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        har_main.main(SMALL + MODELS["vmmodel"] + ["--total", "--ckpt_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_main.main(["--synthetic", "--hidden_size", "8", "--wRank", "4", "--uRanks", "4"])


def test_har_main_checks_the_channels_and_the_task(tmp_path):
    with pytest.raises(SystemExit, match="locomotion requires --channels 113"):
        har_main.main(SMALL + ["--task", "locomotion", "--device", "cpu"])
    # the 113-channel locomotion pipeline: 113 sensors, 5 classes of synthetic windows
    metrics, printed = run(har_main.main, SMALL + [
        "--channels", "113", "--task", "locomotion", "--total", "--device", "cpu",
        "--ckpt_dir", str(tmp_path)])
    assert 0 <= metrics["accuracy"] <= 1 and "Test macro-F1:: " in printed
    # a folder prepared with other channels than the model's is refused
    folder = tmp_path / "opp113"
    folder.mkdir()
    for mode in ("train", "test"):
        np.save(folder / f"X_{mode}.npy", np.zeros((3, 24, 113), np.float32))
        np.save(folder / f"y_{mode}.npy", np.zeros(3, np.int32))
    with pytest.raises(SystemExit, match="113-channel windows"):
        har_main.main(["--dataset_folder", str(folder), "--total", "--device", "cpu",
                       "--max_epochs", "1", "--layer_sizes", "16"])


def test_har_main_runs_the_uci_shape(tmp_path):
    metrics, printed = run(har_main.main, SMALL + MODELS["vmmodel"] + [
        "--data", "UCI", "--total", "--device", "cpu", "--ckpt_dir", str(tmp_path)])
    assert set(metrics) == {"accuracy", "macro_f1"}
    assert (tmp_path / "vmmodel_L16_w4_u4_uci_seed3" / "arrays.npz").exists()
