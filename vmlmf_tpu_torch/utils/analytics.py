"""Compression analytics: parameter counts, the closed-form FLOP model and a
roofline report on the card (counterpart of `vmlmf_tpu.utils.analytics`).

`lstm_cell_flops` and `model_flops` are the reference's compression metric
(`compression_cal.py:72-145`: every gate's low-rank chain counted
separately); `vmlmf_hw_flops` counts what a VMLMF step executes, the
factor products shared by the gates. They are plain Python, the same
numbers as the JAX package's.

`roofline_report` holds a measured region against the card's peaks. The
port knows one card, the H100 SXM at its 700 W limit (dense rates: 67
TFLOP/s f32 outside the tensor cores, 989 TFLOP/s bf16 on them, 3.35 TB/s
of HBM3); another card raises unless ``VMLMF_GPU_PEAKS`` names its peaks
(``"bf16:9.89e14,f32:6.7e13,hbm_bw:3.35e12"``, any subset over the H100's).
"""

from __future__ import annotations

import os

from vmlmf_tpu_torch.utils.tree import tree_leaves

# peaks of each card the port knows: FLOP/s by matmul dtype, HBM bytes/s
GPU_PEAKS = {
    "h100": {"bf16": 989e12, "f32": 67e12, "hbm_bw": 3.35e12},
}
PEAK_KEYS = ("bf16", "f32", "hbm_bw")


def count_params(params) -> int:
    """Elements of every tensor (or array) of a parameter tree."""
    return sum(int(p.numel() if hasattr(p, "numel") else p.size) for p in tree_leaves(params))


def lstm_cell_flops(input_size, hidden_size, w_rank=None, u_rank=None, *,
                    vm=True, bias=True) -> int:
    """FLOPs of one timestep of one cell (`compression_cal.py:72-113`).

    ``vm=False`` gives the vanilla-LSTM count; with ranks set it counts the
    factorized matmuls, the diagonal (vm) multiplies, and the correction adds.
    """
    if isinstance(u_rank, (list, tuple)):
        u_rank = u_rank[0]
    isvm = vm and w_rank is not None

    if isvm:
        input_ops = (2 * input_size - 1) * w_rank + (2 * w_rank - 1) * hidden_size
        hidden_ops = (2 * hidden_size - 1) * u_rank + (2 * u_rank - 1) * hidden_size
        input_dia = input_size
        hidden_dia = hidden_size
        input_add = (2 * w_rank - 1) * input_size + hidden_size
        hidden_add = (2 * u_rank - 1) * hidden_size + hidden_size
        state_ops = (input_ops + hidden_ops + input_dia + hidden_dia
                     + hidden_size * 3 + input_add + hidden_add)
    else:
        input_ops = (2 * input_size - 1) * hidden_size
        hidden_ops = (2 * hidden_size - 1) * hidden_size
        state_ops = input_ops + hidden_ops + hidden_size
    if bias:
        state_ops += hidden_size
    total = state_ops * 4
    total += hidden_size * 3  # f*c + i*g
    total += hidden_size      # o * tanh(c')
    return total


def model_flops(input_size, layer_sizes, seq_len, batch_size, *,
                w_rank=None, u_rank=None, vm=True, num_classes=18) -> int:
    """Whole-model analytic FLOPs (`count_lstm` + `count_linear`)."""
    total = 0
    in_size = input_size
    for h in layer_sizes:
        total += lstm_cell_flops(in_size, h, w_rank, u_rank, vm=vm)
        in_size = h
    total *= seq_len * batch_size
    total += layer_sizes[-1] * num_classes * 2  # classifier head
    return total


def compression_report(baseline_params, compressed_params, *,
                       baseline_flops=None, compressed_flops=None) -> dict:
    """Parameters (K), FLOPs (M) and their ratios, baseline over compressed."""
    rep = {
        "params_baseline_K": baseline_params / 1e3,
        "params_compressed_K": compressed_params / 1e3,
        "compression_ratio": baseline_params / max(compressed_params, 1),
    }
    if baseline_flops is not None and compressed_flops is not None:
        rep["flops_baseline_M"] = baseline_flops / 1e6
        rep["flops_compressed_M"] = compressed_flops / 1e6
        rep["flops_ratio"] = baseline_flops / max(compressed_flops, 1)
    return rep


def vmlmf_hw_flops(input_size, hidden_size, w_rank, u_rank, num_gates=4) -> int:
    """FLOPs one VMLMF cell timestep executes per sample: the four factor
    products (2mn each, shared by the gates), the diagonal epilogue and the
    state update. For MFU and rooflines; `lstm_cell_flops` is the
    reference's report."""
    g = num_gates
    mm = 2 * (input_size * w_rank + w_rank * g * hidden_size
              + hidden_size * u_rank + u_rank * g * hidden_size)
    epilogue = 4 * g * hidden_size + 2 * (input_size + hidden_size)
    state = 4 * hidden_size
    return mm + epilogue + state


def detect_chip(name=None):
    """The key into `GPU_PEAKS` of a card named ``name`` (default: CUDA device
    0, as `torch.cuda.get_device_name` gives it), or the name, lowercased,
    of a card the table does not know."""
    if name is None:
        import torch

        name = torch.cuda.get_device_name(0)
    name = name.lower()
    return next((key for key in GPU_PEAKS if key in name), name)


def chip_peaks(chip=None):
    """-> {bf16, f32, hbm_bw} of ``chip`` (a `GPU_PEAKS` key or a card's
    name; default: the card of CUDA device 0) with
    VMLMF_GPU_PEAKS="key:value,..." applied on top. Raises ValueError for a
    card the table does not know, unless VMLMF_GPU_PEAKS names all three of
    its peaks."""
    over = {}
    for item in filter(None, (i.strip() for i in os.environ.get("VMLMF_GPU_PEAKS", "").split(","))):
        key, _, value = item.partition(":")
        if key.strip() not in PEAK_KEYS:
            raise ValueError(f"VMLMF_GPU_PEAKS key {key.strip()!r} not in {PEAK_KEYS}")
        over[key.strip()] = float(value)
    chip = detect_chip(chip)
    if chip in GPU_PEAKS:
        return {**GPU_PEAKS[chip], **over}
    if set(over) == set(PEAK_KEYS):
        return over
    raise ValueError(f"no peaks for the card {chip!r} (the table knows {sorted(GPU_PEAKS)}): "
                     f"set VMLMF_GPU_PEAKS=\"bf16:...,f32:...,hbm_bw:...\"")


def roofline_report(flops, hbm_bytes, seconds, *, chip=None, dtype="f32") -> dict:
    """Achieved against the roofline for a measured region: ``flops`` its
    analytic FLOP count, ``hbm_bytes`` the bytes it moves, ``seconds`` its
    measured time, on ``chip`` (as `chip_peaks` takes it; default: the card
    of CUDA device 0) at its ``dtype`` rate. -> achieved FLOP/s and bytes/s, arithmetic intensity,
    the ridge, which resource bounds it, the roofline time and the
    fraction of it reached."""
    peaks = chip_peaks(chip)
    peak_flops, peak_bw = peaks[dtype], peaks["hbm_bw"]
    intensity = flops / max(hbm_bytes, 1)
    ridge = peak_flops / peak_bw
    bound = "compute" if intensity >= ridge else "memory"
    t_roofline = max(flops / peak_flops, hbm_bytes / peak_bw)
    return {
        "achieved_flops_per_s": flops / seconds,
        "achieved_bw_bytes_per_s": hbm_bytes / seconds,
        "arithmetic_intensity": intensity,
        "ridge_intensity": ridge,
        "bound": bound,
        "roofline_seconds": t_roofline,
        "fraction_of_roofline": t_roofline / seconds,
    }
