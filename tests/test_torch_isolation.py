"""The port stands alone: importing every module of `vmlmf_tpu_torch` pulls
in neither JAX nor the JAX package, and `chip_smoke.py` refuses to run
without a CUDA device."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import vmlmf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vmlmf_tpu_torch.__path__, "vmlmf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from vmlmf_tpu_torch.nn.models import HARNet  # noqa: F401
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vmlmf_tpu"))
print(len(names), bad)
print(" ".join(names))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_no_jax(tmp_path):
    out = _run(["-c", IMPORT_ALL], tmp_path)
    assert out.returncode == 0, out.stderr
    summary, names = out.stdout.splitlines()
    count, bad = summary.split(maxsplit=1)
    assert int(count) >= 54
    assert bad.strip() == "[]"
    for name in ("train.lm", "train.har", "data.batching", "data.ptb", "data.har", "nn.models",
                 "cells.gru", "ops.cuda_gru", "cells.lstm", "cells.group", "cells.legacy",
                 "config", "ops.cuda_stack", "ops.pipeline", "cli.har_main", "cli.lm_main",
                 "train.checkpoint", "data._native", "data.sliding_window",
                 "data.opp_preprocess", "data.download", "utils.analytics", "utils.timer",
                 "utils.profiling", "serve.ranker", "parallel.mesh", "parallel.spmd",
                 "parallel.sharding", "parallel.pipeline_parallel", "parallel.dryrun",
                 "utils.graphs"):
        assert f"vmlmf_tpu_torch.{name}" in names.split()


def test_chip_smoke_fails_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    out = _run([os.path.join(ROOT, "chip_smoke.py")], tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
