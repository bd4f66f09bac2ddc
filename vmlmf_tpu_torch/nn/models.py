"""Task networks: the HAR classifiers, one-way, bidirectional and with a
convolution front end, and the word-level LM (counterparts of
`vmlmf_tpu.nn.models.HARNet`, `BDNet`, `DeepConvNet` and `LMModel`)."""

from __future__ import annotations

import dataclasses

import torch

from vmlmf_tpu_torch.cells.base import reinit_uniform
from vmlmf_tpu_torch.nn.layers import (
    Bf16Product,
    ConvFeatures,
    Dense,
    Embed,
    dropout,
    dropout_mask,
)
from vmlmf_tpu_torch.nn.recurrence import RNN, WAVEFRONT_BACKENDS, run_wavefront, scan_layer


def _make_cells(cell_factory, input_size, layer_sizes):
    cells, n = [], input_size
    for h in layer_sizes:
        cells.append(cell_factory(n, h))
        n = h
    return tuple(cells)


@dataclasses.dataclass(frozen=True)
class HARNet:
    """RNN stack + linear classifier on the last timestep.

    Input is batch-major ``[B, T, F]``. Parameters are ``{"rnn": [cell dicts],
    "head": {"w", "b"}}``, the JAX package's tree; the head's bias starts at 0.1.
    """

    input_size: int
    layer_sizes: tuple
    cell_factory: dataclasses.InitVar = None
    num_classes: int = 18
    backend: str = "fused"

    def __post_init__(self, cell_factory):
        cells = _make_cells(cell_factory, self.input_size, self.layer_sizes)
        object.__setattr__(self, "rnn", RNN(cells, backend=self.backend))
        object.__setattr__(self, "head", Dense(self.layer_sizes[-1], self.num_classes,
                                               bias_fill=0.1))

    def init(self, generator, device="cuda", dtype=torch.float32):
        """Parameters from ``generator`` (a CPU `torch.Generator`), on ``device``."""
        return {"rnn": self.rnn.init(generator, device, dtype),
                "head": self.head.init(generator, device, dtype)}

    def apply(self, params, x):
        """x: [B, T, F] -> logits [B, num_classes]."""
        ys, _ = self.rnn(params["rnn"], x)
        return self.head(params["head"], ys[:, -1])


@dataclasses.dataclass(frozen=True)
class BDNet:
    """Bidirectional HAR classifier: a forward and a time-reversed tower of
    their own cells, merged by ``merge`` (concat, sum or avg) into the head.

    The reverse tower runs its scans with ``reverse=True`` and is read at
    index 0: its output at original time 0, after it has consumed the whole
    sequence backwards. Parameters are ``{"fwd": [...], "rev": [...],
    "head": {"w", "b"}}``, the JAX package's tree.
    """

    input_size: int
    layer_sizes: tuple
    cell_factory: dataclasses.InitVar = None
    num_classes: int = 18
    merge: str = "concat"
    backend: str = "fused"

    def __post_init__(self, cell_factory):
        if self.merge not in ("concat", "sum", "avg"):
            raise ValueError(f"unknown merge {self.merge!r}")
        for name in ("rnn_f", "rnn_r"):
            cells = _make_cells(cell_factory, self.input_size, self.layer_sizes)
            object.__setattr__(self, name, RNN(cells, backend=self.backend))
        head_in = self.layer_sizes[-1] * (2 if self.merge == "concat" else 1)
        object.__setattr__(self, "head", Dense(head_in, self.num_classes, bias_fill=0.1))

    def init(self, generator, device="cuda", dtype=torch.float32):
        """Parameters from ``generator`` (a CPU `torch.Generator`), on ``device``."""
        return {"fwd": self.rnn_f.init(generator, device, dtype),
                "rev": self.rnn_r.init(generator, device, dtype),
                "head": self.head.init(generator, device, dtype)}

    def apply(self, params, x):
        """x: [B, T, F] -> logits [B, num_classes]."""
        y_f, _ = self.rnn_f(params["fwd"], x)
        y_r, _ = self.rnn_r(params["rev"], x, reverse=True)
        last_f, first_r = y_f[:, -1], y_r[:, 0]
        if self.merge == "concat":
            merged = torch.cat([last_f, first_r], -1)
        elif self.merge == "sum":
            merged = last_f + first_r
        else:
            merged = 0.5 * (last_f + first_r)
        return self.head(params["head"], merged)


@dataclasses.dataclass(frozen=True)
class DeepConvNet:
    """Convolution stack -> RNN -> classifier on the last timestep (the
    DeepConvLSTM workload). The cells' input is channels * input_size wide.

    Input is batch-major ``[B, T, F]`` with T at least layers*(kernel_t-1)+1.
    Parameters are ``{"conv": {...}, "rnn": [...], "head": {"w", "b"}}``, the
    JAX package's tree.
    """

    input_size: int
    layer_sizes: tuple = (128, 128)
    cell_factory: dataclasses.InitVar = None
    num_classes: int = 18
    channels: int = 64
    backend: str = "fused"
    conv_activation: bool = False

    def __post_init__(self, cell_factory):
        object.__setattr__(self, "conv", ConvFeatures(channels=self.channels,
                                                      activation=self.conv_activation))
        cells = _make_cells(cell_factory, self.channels * self.input_size, self.layer_sizes)
        object.__setattr__(self, "rnn", RNN(cells, backend=self.backend))
        object.__setattr__(self, "head", Dense(self.layer_sizes[-1], self.num_classes,
                                               bias_fill=0.1))

    def init(self, generator, device="cuda", dtype=torch.float32):
        """Parameters from ``generator`` (a CPU `torch.Generator`), on ``device``."""
        return {"conv": self.conv.init(generator, device, dtype),
                "rnn": self.rnn.init(generator, device, dtype),
                "head": self.head.init(generator, device, dtype)}

    def apply(self, params, x):
        """x: [B, T, F] -> logits [B, num_classes]."""
        min_t = self.conv.layers * (self.conv.kernel_t - 1) + 1
        if x.shape[1] < min_t:
            raise ValueError(f"DeepConvNet needs at least {min_t} timesteps ({self.conv.layers} "
                             f"valid convs of {self.conv.kernel_t}); got {x.shape[1]}")
        ys, _ = self.rnn(params["rnn"], self.conv(params["conv"], x))
        return self.head(params["head"], ys[:, -1])


@dataclasses.dataclass(frozen=True)
class LMModel:
    """Word-level LM: Embed -> dropout -> (RNN layer -> dropout)×N -> Linear.

    Sequences are time-major ``[T, B]``; the state is carried explicitly.
    Parameters are a dict ``{"embed": {"w"}, "rnn": [cell dicts], "fc":
    {"w", "b"}}`` with the JAX package's keys and layouts (``fc`` holds only
    ``b`` when the embeddings are tied). ``head_bf16``: the softmax
    projection takes bf16 operands and sums in f32 (`Bf16Product`); the
    parameters, the bias and the logits stay f32, the JAX package's opt-in
    mixed precision.
    """

    vocab_size: int
    hidden_size: int = 650
    num_layers: int = 2
    cell_factory: dataclasses.InitVar = None
    dropout_rate: float = 0.5
    winit: float = 0.05
    tie_embeddings: bool = False
    backend: str = "fused"
    head_bf16: bool = False

    def __post_init__(self, cell_factory):
        object.__setattr__(self, "embed", Embed(self.vocab_size, self.hidden_size))
        cells = tuple(
            cell_factory(self.hidden_size, self.hidden_size) for _ in range(self.num_layers)
        )
        object.__setattr__(self, "rnn", RNN(cells, backend=self.backend))
        object.__setattr__(self, "fc", Dense(self.hidden_size, self.vocab_size))

    def init(self, generator, device="cuda", dtype=torch.float32):
        """Parameters from ``generator`` (a CPU `torch.Generator`), on ``device``.

        Every leaf, biases included, is then redrawn from U(-winit, winit),
        the whole-model reset of the LM.
        """
        params = {
            "embed": self.embed.init(generator, device, dtype),
            "rnn": self.rnn.init(generator, device, dtype),
            "fc": self.fc.init(generator, device, dtype),
        }
        params = reinit_uniform(params, generator, self.winit)
        if self.tie_embeddings:
            del params["fc"]["w"]  # the head weight is embed.w transposed
        return params

    def state0(self, batch, device="cuda", dtype=torch.float32):
        return self.rnn.state0(batch, device, dtype)

    def _logits(self, params, x, w=None):
        """The head on ``x``; ``w``: its weight from `head_weight`, made once
        for many calls (decode), else read from ``params``."""
        if w is None:
            w = params["embed"]["w"].T if self.tie_embeddings else params["fc"]["w"]
        y = Bf16Product.apply(x, w) if self.head_bf16 else x @ w
        return y + params["fc"]["b"]

    def head_weight(self, params):
        """The head's [H, V] weight as `_logits` multiplies by it: under
        ``head_bf16`` a bf16 copy (whose cast in `Bf16Product` is then none)."""
        w = params["embed"]["w"].T if self.tie_embeddings else params["fc"]["w"]
        return w.bfloat16() if self.head_bf16 else w

    def apply(self, params, ids, states, *, generator=None, train=False):
        """ids: [T, B] int -> (logits [T, B, V], new_states)."""
        x, new_states = self.apply_hidden(params, ids, states, generator=generator,
                                          train=train)
        return self._logits(params, x), new_states

    def apply_hidden(self, params, ids, states, *, generator=None, train=False):
        """`apply` minus the head: -> (hidden sequence [T, B, H], new_states)."""
        x = self.embed(params["embed"], ids)
        return self.hidden_from_embedded(params, x, states, generator=generator,
                                         train=train)

    def hidden_from_embedded(self, params, x, states, *, generator=None, train=False):
        """`apply_hidden` from a pre-embedded ``x [T, B, H]``.

        In train mode, dropout masks come from ``generator`` (on x's device):
        one after the embedding and one after each layer. On the wavefront
        backends the masks between layers go into the stack: "fused_pipelined"
        draws them, pre-scaled, in the same order and shapes as the per-layer
        path draws its own, so the same generator state gives the same masks;
        "pipelined" draws a fresh mask per wavefront step, as the JAX package's.
        """
        rate = self.dropout_rate if train else 0.0
        x = dropout(x, rate, generator=generator, train=train)
        cells = self.rnn.cells
        if self.backend in WAVEFRONT_BACKENDS:
            preps = [c.prepare(p) for c, p in zip(cells, params["rnn"])]
            masks = None
            if self.backend == "fused_pipelined" and rate > 0.0 and len(cells) > 1:
                masks = [dropout_mask(x.shape, rate, generator, x.device, x.dtype)
                         for _ in range(len(cells) - 1)]
            x, new_states = run_wavefront(self.backend, cells, preps, x, states, masks=masks,
                                          dropout_rate=rate, generator=generator)
        else:
            new_states = []
            for cell, p, s in zip(cells, params["rnn"], states):
                x, sf = scan_layer(cell, cell.prepare(p), x, s, backend=self.backend)
                new_states.append(sf)
                if len(new_states) < len(cells):
                    x = dropout(x, rate, generator=generator, train=train)
        return dropout(x, rate, generator=generator, train=train), new_states
