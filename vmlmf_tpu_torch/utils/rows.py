"""Row gathers and scatter-adds of a table that give equal bits for equal
calls on every device.

``table[ids]`` backpropagates through ``index_put_(accumulate=True)``, and
the ranker's sparse updates call it directly. On a CUDA tensor that op sorts
the indices and adds each run of equal ones in order: deterministic, and the
port keeps it there. On a CPU tensor it adds the rows of one index with
atomics across threads, so the order of the sums, and the bits, change from
run to run. On the CPU these helpers take ``index_select``, whose backward is
``index_add_``, and ``index_add_``, which add each index's rows in the order
they come.
"""

from __future__ import annotations


def take_rows(table, ids):
    """``table[ids]`` for a table ``[N, ...]`` and integer ``ids`` of any
    shape -> ``[*ids.shape, ...]``; its gradient sums each row's cotangents
    in a fixed order on every device."""
    if table.device.type != "cpu":
        return table[ids]
    return table.index_select(0, ids.reshape(-1)).reshape(ids.shape + table.shape[1:])


def add_rows(dst, ids, rows):
    """``dst[ids] += rows`` in place for ``ids [n]`` and ``rows [n, ...]``,
    each row's additions in the order of ``ids``; returns ``dst``."""
    if dst.device.type != "cpu":
        return dst.index_put_((ids,), rows, accumulate=True)
    return dst.index_add_(0, ids, rows)
