"""The experiment configurations: every flag of the HAR and LM experiments as
a typed dataclass field, and the builders of their models (counterpart of
`vmlmf_tpu.config`, with the same fields and defaults).

`HARConfig.build_model` and `LMConfig.build_model` build the port's models.
``backend`` takes the port's names: "fused" (the default, the fused scan
kernels) or "loop", and the two wavefront backends, experiment knobs that
need VMLMF_EXPERIMENTAL_WAVEFRONT=1 (`nn.recurrence`): "fused_pipelined"
(the stack kernels) and "pipelined" (the plain wavefront).
"""

from __future__ import annotations

import dataclasses

from vmlmf_tpu_torch.cells import (
    DiagonalLSTMCell,
    DualDiagonalLSTMCell,
    GRUCell,
    GRUGroupCell,
    LSTMCell,
    LSTMGroupCell,
    VMLMFCell,
    VMLMFGroupCell,
)
from vmlmf_tpu_torch.nn.models import BDNet, DeepConvNet, HARNet, LMModel


@dataclasses.dataclass
class HARConfig:
    # model
    model: str = "mylstm"          # mylstm | vmmodel | vmmodel_group2 | vmgroup_novm | mygru |
                                   # mygru_group | mylstm_group | dualdiag | diag
    layer_sizes: tuple = (180,)
    w_rank: int | None = None
    u_ranks: tuple | None = None   # one element for the cells without groups
    groups: int = 2
    bidirectional: bool = False
    merge: str = "concat"          # BDNet merge: concat | sum | avg
    deepconv: bool = False
    # data
    data: str = "OPP"              # OPP | UCI
    dataset_folder: str | None = None
    num_classes: int = 18
    channels: int = 77             # OPP sensor channels: 77 (challenge) | 113 (legacy)
    task: str = "gestures"         # gestures | locomotion (113-channel pipeline only)
    # training
    lr: float = 2e-3
    batch_size: int = 81
    max_epochs: int = 100
    seed: int = 3
    is_train: bool = True
    # execution: "fused" (the fused scan kernels) | "loop"; with
    # VMLMF_EXPERIMENTAL_WAVEFRONT=1 also "fused_pipelined" | "pipelined"
    backend: str = "fused"

    @property
    def input_size(self):
        return self.channels if self.data.lower() == "opp" else 9

    def _u_scalar(self):
        if self.u_ranks is None:
            return None
        return self.u_ranks[-1] if len(self.u_ranks) < 2 else self.u_ranks[0]

    def cell_factory(self):
        name = self.model.lower()
        w, u = self.w_rank, self._u_scalar()
        if "group" in name and self.u_ranks is None:
            raise ValueError(f"model {self.model!r} needs per-tier recurrent ranks: pass "
                             f"--uRanks r0 r1 ... (one per group, e.g. --uRanks 2 4)")
        ranks = None if self.u_ranks is None else tuple(self.u_ranks)
        if name in ("vmmodel", "vmlmf"):
            return lambda n, h: VMLMFCell(n, h, w_rank=w, u_rank=u)
        if name in ("vmmodel_group2", "vmlmf_group2", "vmgroup"):
            return lambda n, h: VMLMFGroupCell(n, h, w_rank=w, u_ranks=ranks, groups=self.groups)
        if name == "vmgroup_novm":
            return lambda n, h: VMLMFGroupCell(n, h, w_rank=w, u_ranks=ranks, groups=self.groups,
                                               use_vm=False)
        if name == "mylstm":
            return lambda n, h: LSTMCell(n, h, w_rank=w, u_rank=u)
        if name == "mylstm_group":
            return lambda n, h: LSTMGroupCell(n, h, w_rank=w, u_ranks=ranks, groups=self.groups)
        if name == "mygru":
            return lambda n, h: GRUCell(n, h, w_rank=w, u_rank=u)
        if name == "mygru_group":
            return lambda n, h: GRUGroupCell(n, h, w_rank=w, u_ranks=ranks, groups=self.groups)
        if name == "dualdiag":
            return lambda n, h: DualDiagonalLSTMCell(n, h, w_rank=w, u_rank=u)
        if name == "diag":
            return lambda n, h: DiagonalLSTMCell(n, h)
        raise ValueError(f"unsupported cell model {self.model!r}")

    def build_model(self):
        kw = dict(cell_factory=self.cell_factory(), num_classes=self.num_classes,
                  backend=self.backend)
        sizes = tuple(self.layer_sizes)
        if self.deepconv:
            return DeepConvNet(self.input_size, sizes, **kw)
        if self.bidirectional:
            return BDNet(self.input_size, sizes, merge=self.merge, **kw)
        return HARNet(self.input_size, sizes, **kw)


@dataclasses.dataclass
class LMConfig:
    # model
    lstm_type: str = "vmlmf"       # custom | vmlmf | vmgroup  (pytorch, lstm -> custom)
    layer_num: int = 2
    hidden_size: int = 650
    dropout: float = 0.5
    winit: float = 0.05
    w_rank: int = 300
    u_ranks: tuple = (300,)
    groups: int = 2
    tie_embeddings: bool = False
    head_bf16: bool = False        # bf16 softmax-projection matmul (f32 accum)
    # training
    batch_size: int = 20
    seq_length: int = 35
    learning_rate: float = 1.0
    total_epochs: int = 39
    factor_epoch: int = 6
    factor: float = 1.2
    max_grad_norm: float = 5.0
    seed: int = 0
    data_dir: str | None = "./data"
    # execution: "fused" (the fused scan kernels) | "loop"; with
    # VMLMF_EXPERIMENTAL_WAVEFRONT=1 also "fused_pipelined" | "pipelined"
    backend: str = "fused"

    def cell_factory(self):
        t = self.lstm_type.lower()
        u = self.u_ranks[-1] if len(self.u_ranks) < 2 else self.u_ranks[0]
        if t in ("custom", "pytorch", "lstm"):
            return lambda n, h: LSTMCell(n, h)
        if t == "vmlmf":
            return lambda n, h: VMLMFCell(n, h, w_rank=self.w_rank, u_rank=u)
        if t in ("vmgroup", "vm_group"):
            return lambda n, h: VMLMFGroupCell(n, h, w_rank=self.w_rank,
                                               u_ranks=tuple(self.u_ranks), groups=self.groups)
        raise ValueError(f"unsupported lstm_type {self.lstm_type!r}")

    def build_model(self, vocab_size):
        return LMModel(vocab_size, self.hidden_size, self.layer_num,
                       cell_factory=self.cell_factory(), dropout_rate=self.dropout,
                       winit=self.winit, tie_embeddings=self.tie_embeddings,
                       backend=self.backend, head_bf16=self.head_bf16)
