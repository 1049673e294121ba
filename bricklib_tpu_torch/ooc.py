"""Out-of-core stencils: domains held in host memory, streamed through the
card in k-slabs (port of ``bricklib_tpu/ooc.py``).

Each pass cuts the host array into owned k-ranges (:func:`_slab_plan`),
pads each slab on the host (k rows wrapping through the slab indexing, j
and i wrapping per slab) and runs the dense stencil (kernel K7,
``codegen/dense_kernel.py``) on it:

    host slab [s0-pk, s1+pk)  --H2D-->  K7  --D2H-->  host out rows [s0, s1)

The pads and slab height are the reference's, so the slab count and the
bytes moved each way equal the reference's on the same input.  On the
card the next slab's copy to the device overlaps the current slab's
kernel and copy back: the host pads each slab into one of two pinned
staging buffers, a copy stream moves it to the device (ordered by
events), the kernel and the copy back into pinned memory run on the
current stream, and the host reads a result only after its event.  The
device holds at most three slabs (two inputs and one output), the
``slab_bytes`` budget of the reference.  The input array is never
modified.  On the CPU (``device="cpu"``, the tests) the same slabs run
through K7's plain version, one after the other.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .codegen.dense_kernel import dense_stencil
from .codegen.taps import as_ir
from .core import require_device


def _slab_plan(K: int, slab_rows: int):
    """Half-open owned k-ranges covering [0, K).

    Original: ``bricklib_tpu/ooc.py:_slab_plan``."""
    plan = []
    s0 = 0
    while s0 < K:
        s1 = min(s0 + slab_rows, K)
        plan.append((s0, s1))
        s0 = s1
    return plan


def _wrap_fill(dst: torch.Tensor, axis: int, pad: int, n: int) -> None:
    """Fill the ``pad`` cells on each side of ``dst`` along ``axis`` by
    wrapping its ``n`` interior cells (``np.pad(mode="wrap")``)."""
    if pad == 0:
        return
    if pad <= n:
        dst.narrow(axis, 0, pad).copy_(dst.narrow(axis, n, pad))
        dst.narrow(axis, pad + n, pad).copy_(dst.narrow(axis, pad, pad))
        return
    idx = torch.arange(-pad, n + pad) % n + pad
    src = dst.index_select(axis, idx)
    dst.copy_(src)


def _fill_slab(dst: torch.Tensor, src: torch.Tensor, s0: int, s1: int,
               pads: tuple) -> None:
    """The padded slab of rows ``[s0 - pk, s1 + pk)`` of ``src`` (k
    wrapping modulo K), j and i wrapped, written into ``dst`` (host
    tensors)."""
    pk, pj, pi = pads
    K, J, I = src.shape
    core = dst[:, pj:pj + J, pi:pi + I]
    row = 0
    k = s0 - pk
    while k < s1 + pk:
        kw = k % K
        n = min(s1 + pk - k, K - kw)
        core[row:row + n].copy_(src[kw:kw + n])
        row += n
        k += n
    _wrap_fill(dst[:, pj:pj + J], 2, pi, I)
    _wrap_fill(dst, 1, pj, J)


def ooc_sweep(arr, stencil, params: dict | None = None,
              iters: int = 1, slab_bytes: int = 2 * 2 ** 30,
              slab_rows: int | None = None, tile_elems=None,
              stats: dict | None = None, device="cuda"):
    """Apply ``iters`` periodic stencil sweeps to a host-resident 3-D
    array by streaming k-slabs through ``device``; returns the new host
    array as numpy (the input is not modified).

    ``slab_bytes`` bounds the per-slab device footprint (in+out, both
    resident during the overlap window); ``slab_rows`` overrides the
    derived slab height.  ``stats`` (optional dict) receives
    ``{"slabs", "h2d_bytes", "d2h_bytes", "wall_s"}`` per call, as the
    reference's (``wall_s`` counts the passes, not the making of the
    staging buffers before them), plus the host seconds spent padding
    slabs (``pad_s``), blocked on the card's results (``wait_s``) and
    copying them out (``copy_out_s``)."""
    ir = as_ir(stencil)
    if ir.dims != 3:
        raise NotImplementedError("out-of-core path is 3-D")
    if len(ir.sdef.inputs) != 1:
        raise NotImplementedError("out-of-core path reads one grid")
    dev = require_device(device)
    arr = np.asarray(arr)
    K, J, I = arr.shape
    lo, hi = ir.radius()
    # the reference's pads: j rounded up to sublanes, i grown until the
    # padded row is whole 128-lane tiles (the dense kernel's TPU rules)
    pk = max(lo[0], hi[0])
    pj = max(8, -(-max(lo[1], hi[1]) // 8) * 8)
    pi = max(lo[2], hi[2])
    if I % 2:
        raise ValueError("out-of-core i extent must be even")
    pi += ((-(I + 2 * pi)) % 128) // 2
    if J % 8:
        raise ValueError("out-of-core j extent must be a sublane "
                         "multiple (8)")
    row_bytes = (J + 2 * pj) * (I + 2 * pi) * arr.dtype.itemsize
    if slab_rows is None:
        slab_rows = max(1, int(slab_bytes // (3 * row_bytes)) - 2 * pk)
    slab_rows = min(slab_rows, K)
    plan = _slab_plan(K, slab_rows)
    pads = (pk, pj, pi)

    fns: dict = {}

    def fn_for(rows: int):
        if rows not in fns:
            shape = (rows + 2 * pk, J + 2 * pj, I + 2 * pi)
            fns[rows] = dense_stencil(ir, shape, pads, params,
                                      tile_elems=tile_elems)
        return fns[rows]

    cur = torch.from_numpy(np.ascontiguousarray(arr))
    counts = {"h2d_bytes": 0, "d2h_bytes": 0, "pad_s": 0.0, "wait_s": 0.0,
              "copy_out_s": 0.0}
    run = (_run_cpu if dev.type == "cpu"
           else _cuda_pass(cur, plan, pads, dev))
    t0 = time.perf_counter()
    for _ in range(int(iters)):
        cur = run(cur, plan, pads, fn_for, counts)
    if stats is not None:
        stats.update(slabs=len(plan), wall_s=time.perf_counter() - t0,
                     **counts)
    return cur.numpy()


def _run_cpu(cur, plan, pads, fn_for, counts):
    """One pass on the CPU: each slab padded, swept and copied out in
    turn."""
    pk, pj, pi = pads
    K, J, I = cur.shape
    out = torch.empty_like(cur)
    for s0, s1 in plan:
        rows = s1 - s0
        slab = torch.empty((rows + 2 * pk, J + 2 * pj, I + 2 * pi),
                           dtype=cur.dtype)
        _fill_slab(slab, cur, s0, s1, pads)
        res = fn_for(rows)(slab)
        counts["h2d_bytes"] += slab.numel() * slab.element_size()
        counts["d2h_bytes"] += res.numel() * res.element_size()
        out[s0:s1] = res[pk:pk + rows, pj:pj + J, pi:pi + I]
    return out


def _cuda_pass(arr, plan, pads, dev):
    """One pass on the card, pipelined: slab s+1 is padded on the host and
    copied to the device while slab s runs and comes back.  The buffers
    are made once and serve every pass.

    Two pinned input buffers and two device input buffers alternate; an
    input buffer is refilled only after its previous copy to the device
    has ended (event ``sent``), and a device buffer only after the kernel
    that read it has ended (event ``used``).  Each slab's output comes back
    into a pinned buffer on the current stream, and the host copies it out
    only after event ``back``."""
    pk, pj, pi = pads
    K, J, I = arr.shape
    rows0 = plan[0][1] - plan[0][0]
    full = (rows0 + 2 * pk, J + 2 * pj, I + 2 * pi)
    pin_in = [torch.empty(full, dtype=arr.dtype, pin_memory=True)
              for _ in range(2)]
    pin_out = [torch.empty(full, dtype=arr.dtype, pin_memory=True)
               for _ in range(2)]
    dev_in = [torch.empty(full, dtype=arr.dtype, device=dev)
              for _ in range(2)]
    comp = torch.cuda.current_stream(dev)
    copy = torch.cuda.Stream(dev)

    def one_pass(cur, plan, pads, fn_for, counts):
        sent = [None, None]
        used = [None, None]
        back = [None, None]
        out = torch.empty_like(cur)

        def drain(s):
            s0, s1 = plan[s]
            t = time.perf_counter()
            back[s % 2].synchronize()
            t1 = time.perf_counter()
            out[s0:s1].copy_(
                pin_out[s % 2][pk:pk + s1 - s0, pj:pj + J, pi:pi + I])
            counts["wait_s"] += t1 - t
            counts["copy_out_s"] += time.perf_counter() - t1

        for s, (s0, s1) in enumerate(plan):
            b = s % 2
            nk = s1 - s0 + 2 * pk
            t = time.perf_counter()
            if sent[b] is not None:
                sent[b].synchronize()
            host = pin_in[b][:nk]
            _fill_slab(host, cur, s0, s1, pads)
            counts["pad_s"] += time.perf_counter() - t
            d_in = dev_in[b][:nk]
            with torch.cuda.stream(copy):
                if used[b] is not None:
                    copy.wait_event(used[b])
                d_in.copy_(host, non_blocking=True)
                sent[b] = torch.cuda.Event()
                sent[b].record(copy)
            counts["h2d_bytes"] += host.numel() * host.element_size()
            if s > 0:
                drain(s - 1)
            comp.wait_event(sent[b])
            res = fn_for(s1 - s0)(d_in)
            used[b] = torch.cuda.Event()
            used[b].record(comp)
            pin_out[b][:nk].copy_(res, non_blocking=True)
            back[b] = torch.cuda.Event()
            back[b].record(comp)
            counts["d2h_bytes"] += res.numel() * res.element_size()
            del res
        drain(len(plan) - 1)
        return out

    return one_pass
