"""Ghost exchange on one device (port of ``bricklib_tpu/comm/exchange.py``).

The multi-stage SHIFT exchange (ref: MultiStageExchangeView semantics):
stages run innermost axis first, and each moves the ghost sections whose
last axis (in stage order) is the stage's axis, corners forwarded out of
ghosts an earlier stage wrote.  On a mesh whose every axis has one device
each move is a periodic self-copy inside one storage buffer, done by
kernel K2 (``csrc/brick_copy.cu``) one launch per stage, in place.
"""

from __future__ import annotations

import numpy as np
import torch


from .. import _build
from ..core import not_ported
from .decomp import BrickDecomp

MULTI_GPU_ITEM = "multi-GPU"


def _merge_intervals(pairs):
    """Merge (dst section, src section) pairs into maximal contiguous
    interval pairs ``[(d0, d1, s0, s1), ...]``."""
    ivs = sorted((d.pos, d.pos + d.len, s.pos, s.pos + s.len)
                 for d, s in pairs)
    out = []
    for d0, d1, s0, s1 in ivs:
        if out and out[-1][1] == d0 and out[-1][3] == s0:
            prev = out[-1]
            out[-1] = (prev[0], d1, prev[2], s1)
        else:
            out.append((d0, d1, s0, s1))
    return out


def check_stage(dsts, srcs) -> None:
    """Within one stage no destination row range may overlap another
    destination or any source range in the same storage: the TPU issued a
    stage's copies concurrently, and so do the blocks of one K2 or K5
    launch."""
    dst = sorted(dsts)
    for (_a0, a1), (b0, _b1) in zip(dst, dst[1:]):
        if b0 < a1:
            raise ValueError(f"stage destinations overlap: {dst}")
    for d0, d1 in dst:
        for s0, s1 in srcs:
            if d0 < s1 and s0 < d1:
                raise ValueError(f"stage destination [{d0}, {d1}) overlaps "
                                 f"source [{s0}, {s1})")


def shift_stages(decomp: BrickDecomp, mesh_shape, table_axes=(),
                 axis_order=None) -> list[list[tuple[int, int, int, int]]]:
    """The SHIFT exchange as a list of stages of brick-row intervals
    ``(d0, d1, s0, s1)``: ``dat[d0:d1] = dat[s0:s1]``.  Stages on
    ``table_axes`` are skipped, and so are sections with an owner
    component on a table axis: the sweep reads those directions through a
    ``periodic_grid`` table.  Follows ``exchange_shift``
    (``bricklib_tpu/comm/exchange.py:193``)."""
    mesh_shape = tuple(int(m) for m in mesh_shape)
    if any(m > 1 for m in mesh_shape):
        raise not_ported(f"exchange over mesh {mesh_shape}", MULTI_GPU_ITEM)
    order, stages = decomp.stage_sections(axis_order)
    table_axes = set(table_axes)

    def owner_axes(sec):
        return {decomp._tag_axis(t) for t in sec.owner}

    out = []
    for s, ax in enumerate(order):
        if ax in table_axes:
            continue
        ivs = []
        for sign in (+1, -1):
            pairs = [(d, sr) for d, sr in stages[s][sign]
                     if not (owner_axes(d) & table_axes)]
            if pairs:
                ivs.extend(_merge_intervals(pairs))
        if ivs:
            check_stage([(d0, d1) for d0, d1, _, _ in ivs],
                        [(s0, s1) for _, _, s0, s1 in ivs])
            out.append(ivs)
    return out


def copy_intervals_plain(dat: torch.Tensor, ivs) -> torch.Tensor:
    """The plain PyTorch version of kernel K2: one stage, in place."""
    for d0, d1, s0, s1 in ivs:
        dat[d0:d1].copy_(dat[s0:s1])
    return dat


def _row_vecs(dat: torch.Tensor) -> int:
    """16-byte vectors per brick row of ``dat``; raises if a row is not a
    whole number of them."""
    row_bytes = dat[0].numel() * dat.element_size()
    if row_bytes % 16:
        raise ValueError(f"kernel K2 copies 16-byte vectors; a brick row "
                         f"is {row_bytes} bytes")
    return row_bytes // 16


def interval_table(ivs, dat: torch.Tensor) -> torch.Tensor:
    """The device table kernel K2 reads for one stage: ``(dst, src, len)``
    per interval, in 16-byte vectors, int64, on the device of ``dat``."""
    rv = _row_vecs(dat)
    rows = [(d0 * rv, s0 * rv, (d1 - d0) * rv) for d0, d1, s0, s1 in ivs]
    return torch.tensor(rows, dtype=torch.int64).to(dat.device)


def copy_intervals(dat: torch.Tensor, ivs, table: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """One exchange stage, in place: ``dat[d0:d1] = dat[s0:s1]`` for every
    interval.  A CPU tensor takes the plain version; a CUDA tensor
    launches kernel K2 on the current stream (``table``: the stage's
    :func:`interval_table`, built here when not given)."""
    if not dat.is_contiguous():
        raise ValueError("exchange storage must be contiguous")
    n = dat.shape[0]
    for d0, d1, s0, s1 in ivs:
        if not (0 <= d0 < d1 <= n and 0 <= s0 < s1 <= n
                and d1 - d0 == s1 - s0):
            raise ValueError(f"interval ({d0}, {d1}, {s0}, {s1}) invalid "
                             f"for {n} brick rows")
    if dat.device.type == "cpu":
        return copy_intervals_plain(dat, ivs)
    if dat.device.type != "cuda":
        raise ValueError(f"kernel K2 runs on CUDA tensors, got {dat.device}")
    if table is None:
        table = interval_table(ivs, dat)
    if (table.device != dat.device or table.dtype != torch.int64
            or tuple(table.shape) != (len(ivs), 3)):
        raise ValueError("interval table must be int64 [n, 3] on the "
                         "storage's device")
    rv = _row_vecs(dat)
    max_len = max(d1 - d0 for d0, d1, _s0, _s1 in ivs) * rv
    err = _build.library().bt_copy_intervals(
        dat.data_ptr(), table.data_ptr(), len(ivs), max_len,
        _build.stream_handle(dat.device))
    _build.check(err, "copy_intervals")
    copy_intervals.launches += 1
    return dat


copy_intervals.launches = 0


def shift_exchange(decomp: BrickDecomp, mesh_shape, table_axes=(),
                   axis_order=None):
    """Plan the SHIFT exchange once; returns ``fn(dat) -> dat`` that runs
    it in place, one K2 launch per stage.  Device interval tables are
    made on the first call on each device, so a timed step copies nothing
    from the host."""
    stages = shift_stages(decomp, mesh_shape, table_axes, axis_order)
    tables: dict = {}

    def fn(dat: torch.Tensor) -> torch.Tensor:
        if dat.shape[0] != decomp.nbricks:
            raise ValueError(f"storage has {dat.shape[0]} brick rows, the "
                             f"decomposition {decomp.nbricks}")
        if dat.device.type == "cuda" and dat.device not in tables:
            tables[dat.device] = [interval_table(ivs, dat) for ivs in stages]
        for s, ivs in enumerate(stages):
            copy_intervals(dat, ivs, tables[dat.device][s]
                           if dat.device in tables else None)
        return dat

    fn.stages = stages
    return fn


def exchange_shift(dat: torch.Tensor, decomp: BrickDecomp, mesh_shape,
                   table_axes=(), axis_order=None) -> torch.Tensor:
    """Multi-stage SHIFT exchange on a mesh whose every axis has one
    device.  ``dat`` (``[nbricks, ...]`` storage) is updated IN PLACE, as
    ``input_output_aliases`` does on the TPU, and returned.  A mesh axis
    with more than one device raises ``NotImplementedError``.  For a
    repeated step, build the plan once with :func:`shift_exchange`."""
    return shift_exchange(decomp, mesh_shape, table_axes, axis_order)(dat)
