from vmlmf_tpu_torch.cells.base import Cell, lstm_update, reinit_uniform  # noqa: F401
from vmlmf_tpu_torch.cells.lstm import LSTMCell  # noqa: F401
from vmlmf_tpu_torch.cells.vmlmf import VMLMFCell  # noqa: F401
from vmlmf_tpu_torch.cells.group import VMLMFGroupCell, LSTMGroupCell  # noqa: F401
from vmlmf_tpu_torch.cells.gru import GRUCell, GRUGroupCell  # noqa: F401
from vmlmf_tpu_torch.cells.legacy import DualDiagonalLSTMCell, DiagonalLSTMCell  # noqa: F401
