"""Kernel K2's pool plan (``comm/exchange.py``, ``PoolPlan``) on the CPU.

K2 runs every run of consecutive local stages of an exchange in one launch:
the stages' copies cut into chunks of one brick row, in stage order, drawn
by the blocks from a counter; a chunk whose source row an earlier stage of
the launch writes waits on that row's arrival counter (its gate).
For the weak 3-D plan (i through the table, and every axis exchanged), the
4-D plan, the 5-D ``Problem``'s plan (whole-brick ghosts, mesh (1, 1, 1,
1, 2) on one card), the PUT exchange's self-copies and a card holding four
ranks (mesh (2, 2, 1)): the chunks come in stage order and write every
destination row of a stage once; exactly the chunks whose source row an
earlier stage writes carry that row's gate, after the chunk it counts;
and an emulation that runs the chunks in random orders the gates allow
leaves the storage that the plain version leaves, stage by stage, and
that the reference's ``exchange_shift`` leaves, bit for bit.  The kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu.comm import BrickDecomp as RefDecomp
from bricklib_tpu.comm import skinlist_by_name as ref_skins
from bricklib_tpu.comm.exchange import exchange_shift as exchange_shift_ref
from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu_torch.comm.exchange import (PoolPlan, card_intervals,
                                              copy_intervals, copy_stages,
                                              copy_stages_plain, put_copies,
                                              shift_exchange, shift_stages,
                                              stage_copies, stage_groups)
from bricklib_tpu_torch.comm.mesh import make_domain_mesh

PLANS = {
    "weak 3-D, i through the table": ((32, 32, 32), (8, 8, 32), (8, 8, 0),
                                      (1, 1, 1), (2,)),
    "weak 3-D, every axis": ((32, 32, 32), (8, 8, 32), (8, 8, 0),
                             (1, 1, 1), ()),
    "ghosts on every axis": ((16, 16, 32), (4, 4, 8), (4, 4, 8), (1, 1, 1),
                             ()),
    "weak 4-D": ((8, 16, 16, 32), (4, 4, 4, 32), (4, 4, 4, 0),
                 (1, 1, 1, 1), (3,)),
    "5-D Problem, 2 ranks": ((8, 8, 16, 16, 32), (2, 2, 4, 4, 16),
                             (2, 2, 4, 4, 16), (1, 1, 1, 1, 2), ()),
    "4 ranks on one card": ((16, 16, 32), (4, 4, 8), (4, 4, 8), (2, 2, 1),
                            ()),
}
# groups of local stages: stages per launch, in order
GROUPS = {"weak 3-D, i through the table": [2],
          "weak 3-D, every axis": [2], "ghosts on every axis": [3],
          "weak 4-D": [3], "5-D Problem, 2 ranks": [4],
          "4 ranks on one card": [1]}


def _dec(dims, bd, gz, pkg=None):
    bdec, skins = ((RefDecomp, ref_skins) if pkg == "ref"
                   else (BrickDecomp, skinlist_by_name))
    return bdec(dims=dims, ghost_depth=gz, bdims=bd).initialize(
        skins("good", len(dims)))


def _groups(name):
    """``(dec, ranks, [stage intervals of each local group on the card])``
    with every rank on one card."""
    dims, bd, gz, mesh_shape, table_axes = PLANS[name]
    dec = _dec(dims, bd, gz)
    n = int(np.prod(mesh_shape))
    mesh = make_domain_mesh(mesh_shape, devices=["cpu"] * n)
    stages = shift_stages(dec, mesh_shape, table_axes)
    out = []
    for ss in stage_groups(stages):
        if stages[ss[0]].remote:
            continue
        out.append([card_intervals(mesh, stage_copies(stages[s], mesh_shape),
                                   dec.nbricks)[0] for s in ss])
    return dec, n, out


def _put_groups():
    dec = _dec(*PLANS["weak 3-D, every axis"][:3])
    local = [c for c in put_copies(dec, (1, 1, 1), (2,)) if not c[6]]
    return dec, 1, [[[(d0, d1, s0, s1) for _r, d0, d1, _q, s0, s1, _
                      in local]]]


def _plans(name):
    dec, n, groups = _put_groups() if name == "PUT" else _groups(name)
    return dec, n, [PoolPlan(g, n * dec.nbricks, 1) for g in groups]


ALL = list(PLANS) + ["PUT"]


@pytest.mark.parametrize("name", list(PLANS))
def test_local_stages_form_one_launch(name):
    dims, bd, gz, mesh_shape, table_axes = PLANS[name]
    stages = shift_stages(_dec(dims, bd, gz), mesh_shape, table_axes)
    groups = stage_groups(stages)
    assert [s for g in groups for s in g] == list(range(len(stages)))
    local = [len(g) for g in groups if not stages[g[0]].remote]
    assert local == GROUPS[name]
    for g in groups:
        if stages[g[0]].remote:
            assert len(g) == 1


@pytest.mark.parametrize("name", ALL)
def test_chunks_in_stage_order_write_each_row_once(name):
    _dec_, _n, plans = _plans(name)
    for plan in plans:
        st = [c[2] for c in plan.chunks]
        assert st == sorted(st)
        for s, ivs in enumerate(plan.stage_ivs):
            want = sorted((d0 + r, s0 + r) for d0, d1, s0, _ in ivs
                          for r in range(d1 - d0))
            got = sorted((c[0], c[1]) for c in plan.chunks if c[2] == s)
            assert got == want
            assert len({d for d, _ in got}) == len(got)


@pytest.mark.parametrize("name", ALL)
def test_gates_are_exactly_the_reads_of_earlier_stages(name):
    _dec_, _n, plans = _plans(name)
    for plan in plans:
        index = {key: k for k, key in enumerate(plan.counters)}
        wrote = [{d0 + r for d0, d1, _, _ in ivs for r in range(d1 - d0)}
                 for ivs in plan.stage_ivs]
        writer = {(c[2], c[0]): q for q, c in enumerate(plan.chunks)}
        for pos, (dst, src, s, counter, gates) in enumerate(plan.chunks):
            want = {index[(e, src)] for e in range(s) if src in wrote[e]}
            assert set(gates) == want and len(gates) == len(want)
            for k in gates:
                # the row the gate counts is written by one earlier chunk
                counted = [q for q, c in enumerate(plan.chunks)
                           if c[3] == k]
                assert counted == [writer[plan.counters[k]]]
                assert counted[0] < pos
        # a row has a counter exactly when a later stage reads it
        read_later = {(e, c[1]) for c in plan.chunks for e in range(c[2])
                      if c[1] in wrote[e]}
        assert set(plan.counters) == read_later
        gated = sum(1 for c in plan.chunks if c[4])
        if len(plan.stage_ivs) > 1:
            assert gated > 0          # the corners read earlier stages
        else:
            assert gated == 0 and not plan.counters


def _emulate(dat: np.ndarray, plan: PoolPlan, rng) -> None:
    """Run the chunks in a random order the gates allow: a chunk may run
    once the rows its gates count are written."""
    arrived = [0] * len(plan.counters)
    waiting = {}                # counter -> the chunks it gates
    pending = []                # per chunk, its gates not yet open
    for q, c in enumerate(plan.chunks):
        pending.append(len(c[4]))
        for k in c[4]:
            waiting.setdefault(k, []).append(q)
    ready = [q for q, n in enumerate(pending) if n == 0]
    done = 0
    while ready:
        i = int(rng.integers(len(ready)))
        ready[i], ready[-1] = ready[-1], ready[i]
        q = ready.pop()
        dst, src, _s, counter, _g = plan.chunks[q]
        dat[dst] = dat[src]
        done += 1
        if counter >= 0:
            arrived[counter] += 1
            if arrived[counter] == 1:
                for w in waiting.get(counter, ()):
                    pending[w] -= 1
                    if pending[w] == 0:
                        ready.append(w)
    assert done == len(plan.chunks)


@pytest.mark.parametrize("name", ALL)
def test_any_order_the_gates_allow_equals_the_plain_version(name):
    dec, n, plans = _plans(name)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n * dec.nbricks,) + tuple(dec.bdims)
                            ).astype(np.float32)
    for plan in plans:
        want = torch.from_numpy(x.copy())
        copy_stages_plain(want, plan.stage_ivs)
        for _ in range(2):
            got = x.copy()
            _emulate(got, plan, rng)
            assert np.array_equal(got, want.numpy())
        x = want.numpy()


@pytest.mark.parametrize("name", ["weak 3-D, i through the table",
                                  "weak 3-D, every axis",
                                  "ghosts on every axis", "weak 4-D"])
def test_emulated_pool_equals_the_reference_exchange(name):
    dims, bd, gz, mesh_shape, table_axes = PLANS[name]
    dec, _n, plans = _plans(name)
    assert len(plans) == 1
    x = np.random.default_rng(6).standard_normal(
        (dec.nbricks,) + tuple(bd)).astype(np.float32)
    names = tuple("xyzw"[:len(dims)])
    want = np.asarray(exchange_shift_ref(
        jnp.asarray(x), _dec(dims, bd, gz, "ref"), names, mesh_shape,
        interpret=True, table_axes=table_axes))
    got = x.copy()
    _emulate(got, plans[0], np.random.default_rng(7))
    assert np.array_equal(got, want)
    assert not np.array_equal(got, x)


def test_the_exchange_on_the_cpu_is_the_plain_version():
    dec = _dec(*PLANS["ghosts on every axis"][:3])
    ex = shift_exchange(dec, (1, 1, 1))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (dec.nbricks,) + tuple(dec.bdims)).astype(np.float32))
    want = copy_stages_plain(x.clone(), ex.stages)
    before = copy_intervals.launches
    got = ex(x.clone())
    assert copy_intervals.launches == before      # the CPU: no kernel
    assert torch.equal(got, want)
    assert torch.equal(copy_stages(x.clone(), ex.stages), want)


def test_a_stage_writing_what_an_earlier_one_reads_raises():
    """Only reads of earlier stages' rows are gated: a later stage that
    writes rows an earlier one reads or writes cannot share its launch."""
    for stages in ([[(0, 2, 4, 6)], [(4, 5, 8, 9)]],     # writes a source
                   [[(0, 2, 4, 6)], [(1, 2, 8, 9)]]):    # writes a dest
        with pytest.raises(ValueError, match="same launch"):
            PoolPlan(stages, 10, 1)
    with pytest.raises(ValueError, match="overlap"):
        PoolPlan([[(0, 2, 4, 6), (1, 3, 6, 8)]], 10, 1)
    with pytest.raises(ValueError, match="invalid"):
        PoolPlan([[(8, 11, 0, 3)]], 10, 1)
