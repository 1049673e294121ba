"""Device meshes (port of ``bricklib_tpu/comm/mesh.py:14-88``; ref:
weak/args.cpp:105-108, brick-mpi.h:730-753).

A :class:`Mesh` is the counterpart of ``jax.sharding.Mesh`` in one
process, as ``shard_map`` is a single controller: a shape, one axis name
per domain axis, and one ``torch.device`` per rank in row-major ravel
order.  A device may be named several times, and its ranks then share it,
as the reference's tests share 8 virtual CPU devices: four ranks on one
card is ``make_domain_mesh((2, 2, 1), devices=["cuda:0"] * 4)``.

The state of a mesh step is one contiguous tensor per distinct device (a
*card* below, the CPU included), ``[p, ...]``, holding the ``p`` ranks
placed there in ravel order; :meth:`Mesh.place` maps a rank to its
``(card, slot)`` and every exchange goes through it.  Ranks on distinct
cards write into each other's storage through unified addresses, so
:func:`make_domain_mesh` enables peer access between every pair of its
cards and raises where CUDA refuses it: there is no staged-copy
fallback.

``make_multislice_mesh`` (DCN slices) and ``shard_map`` are not ported:
one process drives every rank, and multi-host meshes wait for ROADMAP.md
Queue 1.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import require_device

DEFAULT_AXIS_NAMES = ("w", "z", "y", "x")  # outermost-first domain axes


def domain_axis_names(ndim: int) -> tuple[str, ...]:
    if ndim <= len(DEFAULT_AXIS_NAMES):
        return DEFAULT_AXIS_NAMES[-ndim:]
    extra = tuple(f"d{a}" for a in range(ndim - len(DEFAULT_AXIS_NAMES)))
    return extra + DEFAULT_AXIS_NAMES


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``cuda`` names the current
    card, so that equal cards compare equal."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        dev = torch.device("cuda", idx)
    return dev


class Mesh:
    """``shape`` ranks per axis, ``axis_names``, and ``devices``: one per
    rank in ravel order, repeats allowed.  ``cards`` are the distinct
    devices in order of first appearance."""

    def __init__(self, shape, axis_names, devices):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.devices = tuple(_device(d) for d in devices)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{len(self.shape)}-axis mesh")
        if len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, "
                             f"got {len(self.devices)} devices")
        cards: list[torch.device] = []
        place = []
        count: dict[int, int] = {}
        for d in self.devices:
            if d not in cards:
                cards.append(d)
            c = cards.index(d)
            place.append((c, count.get(c, 0)))
            count[c] = count.get(c, 0) + 1
        self.cards = tuple(cards)
        self._place = tuple(place)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def coords_of(self, rank: int) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(int(rank), self.shape))

    def rank_of(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(int(c) for c in coords),
                                        self.shape))

    def place(self, rank: int) -> tuple[int, int]:
        """``(card, slot)`` of ``rank``: its state is ``state[card][slot]``."""
        return self._place[int(rank)]

    def ranks_on(self, card: int) -> list[int]:
        """The ranks on ``card``, in slot order."""
        return [r for r, (c, _s) in enumerate(self._place) if c == card]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"devices={[str(d) for d in self.devices]})")


def to_state(mesh: Mesh, arrays) -> list[torch.Tensor]:
    """The state of ``mesh`` from one host array per rank (ravel order, all
    of one shape): per card, the ``[p, ...]`` stack of its ranks' arrays,
    on that card."""
    return [torch.from_numpy(np.ascontiguousarray(np.stack(
        [arrays[r] for r in mesh.ranks_on(c)]))).to(dev)
        for c, dev in enumerate(mesh.cards)]


def rank_views(mesh: Mesh, state) -> list[torch.Tensor]:
    """One view per rank (ravel order) into ``state``."""
    return [state[c][s] for c, s in (mesh.place(r) for r in range(mesh.size))]


def check_state(mesh: Mesh, state, rank_shape) -> None:
    """``state`` must hold, per card of ``mesh``, one contiguous tensor
    ``[p, *rank_shape]`` on that card, all of one dtype."""
    if len(state) != len(mesh.cards):
        raise ValueError(f"the state has {len(state)} tensors, the mesh "
                         f"{len(mesh.cards)} cards")
    for c, t in enumerate(state):
        want = (len(mesh.ranks_on(c)),) + tuple(rank_shape)
        if (tuple(t.shape[:len(want)]) != want or t.device != mesh.cards[c]
                or not t.is_contiguous() or t.dtype != state[0].dtype):
            raise ValueError(f"state[{c}] must be contiguous {want} (ranks, "
                             f"brick rows) on {mesh.cards[c]}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def enable_peer_access(devices) -> None:
    """Let every pair of distinct CUDA devices in ``devices`` address each
    other's memory (``cudaDeviceCanAccessPeer``,
    ``cudaDeviceEnablePeerAccess``); raises where a pair is refused."""
    from .. import _build

    idx = sorted({_device(d).index for d in devices
                  if _device(d).type == "cuda"})
    if len(idx) < 2:
        return
    lib = _build.library()
    for a in idx:
        for b in idx:
            if a == b:
                continue
            ok = ctypes.c_int(0)
            _build.check(lib.bt_can_access_peer(a, b, ctypes.byref(ok)),
                         "cudaDeviceCanAccessPeer")
            if not ok.value:
                raise RuntimeError(f"peer access from cuda:{a} to cuda:{b} "
                                   "refused: the mesh exchanges write "
                                   "straight into a neighbour's memory")
            _build.check(lib.bt_enable_peer_access(a, b),
                         "cudaDeviceEnablePeerAccess")


def make_domain_mesh(mesh_shape, names=None, devices=None) -> Mesh:
    """A :class:`Mesh` whose axes map one-to-one onto domain axes
    (outermost first).  ``devices``: one per rank in ravel order (a flat
    sequence or an array of the mesh's shape), repeats allowed; ``None``
    takes the first ``prod(mesh_shape)`` CUDA devices and raises if there
    are fewer (it never falls back to the CPU)."""
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if names is None:
        names = domain_axis_names(len(mesh_shape))
    n = int(np.prod(mesh_shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(
                f"need {n} CUDA devices, have {have}: pass devices= to place "
                "several ranks on one card")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [require_device(d) for d in
                   np.asarray(devices, dtype=object).ravel()]
    mesh = Mesh(mesh_shape, names, devices)
    enable_peer_access(mesh.cards)
    return mesh


def run_mesh(mesh_shape, device="cuda", devices=None) -> Mesh:
    """The mesh a driver runs on: ``devices`` if given; otherwise every
    rank on the CPU when ``device`` is the CPU, the one rank of a
    one-rank mesh on ``device``, or one card per rank
    (:func:`make_domain_mesh`, which raises where there are too few)."""
    n = int(np.prod(tuple(mesh_shape)))
    if devices is None:
        dev = torch.device(device)
        if dev.type == "cpu" or n == 1:
            devices = [dev] * n
    return make_domain_mesh(mesh_shape, devices=devices)


def make_flat_mesh(mesh_shape, name="dev", devices=None) -> Mesh:
    """A 1-axis mesh over the same devices in ``mesh_shape`` ravel order,
    placement-identical to :func:`make_domain_mesh`."""
    full = make_domain_mesh(mesh_shape, devices=devices)
    return Mesh((full.size,), (name,), full.devices)
