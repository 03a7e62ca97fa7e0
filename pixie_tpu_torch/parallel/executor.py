"""Distributed fragment execution over an agent mesh of virtual PEMs.

A port of the JAX package's ``parallel/executor.py``. The JAX engine
compiles the whole topology into one ``shard_map`` program per window;
here the same topology runs eagerly, shard by shard:

    window planes, split into the mesh's row shards (views)
      └─ per slot: Map/Filter + local group state  (the PEM fragment,
         ``frag.window_state``: the dense_fold / hist_fold kernels)
      └─ balanced pairwise merge of the states over ``agents``
         (the PEM -> Kelvin bridge)
      └─ (2D mesh) a second tree merge over ``kelvin``
      └─ merge into the running query state

Where slots sit on different devices, the gather is each state's copy
onto the merging slot's device; with repeated slots (virtual PEMs on one
card) it is a no-op, and every shard of a resident window is a view of
the window's planes, so the mesh reads the windows staged at append
time as they are.

What the JAX module has and this one does not: the table's
``stage_sharding`` / ``stage_capacity_multiple`` and the engine's
``_window_capacity`` padding (a window's capacity a multiple of the
slot count, so ``shard_map`` divides it evenly). Shards here are
``torch.tensor_split`` views and may be uneven (a degraded 3-slot mesh
over a 2^k-row window), so no window is padded or staged differently
for the mesh. Nor the single-device CPU thread-parallel fold, the TPU
scan fold and the cache of jitted steps: eager PyTorch has nothing to
compile or to recompile.
"""

from __future__ import annotations

import threading
import weakref

import torch

from ..exec.engine import Engine, QueryError
from ..exec.fragment import compile_fragment
from ..exec.stream import _stream_col_stats
from .mesh import AgentMesh, agent_mesh, row_shards, shard_bounds

__all__ = ["DistributedEngine", "distributed_agg_step",
           "distributed_rows_step", "shard_valid"]


def _tree_to(x, device: torch.device):
    """A group state (nested dicts/tuples of tensors) on ``device``; the
    same object when it is there already."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    if isinstance(x, dict):
        return {k: _tree_to(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_to(v, device) for v in x)
    return x


def _state_device(state) -> torch.device | None:
    """The device of a state's first tensor."""
    if isinstance(state, torch.Tensor):
        return state.device
    vals = state.values() if isinstance(state, dict) else (
        state if isinstance(state, (tuple, list)) else ()
    )
    for v in vals:
        d = _state_device(v)
        if d is not None:
            return d
    return None


def _axis_fold_merge(states: list, merge):
    """Tree-merge the states of one mesh axis: a balanced pairwise tree,
    ceil(log2(D)) levels deep, each pair merged on its left state's
    device. Odd tails carry over unmerged to the next level. The merge
    is associative (the UDA contract)."""
    level = list(states)
    while len(level) > 1:
        nxt = []
        for j in range(0, len(level) - 1, 2):
            a, b = level[j], level[j + 1]
            dev = _state_device(a)
            nxt.append(merge(a, b if dev is None else _tree_to(b, dev)))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def shard_valid(valid, n: int, mesh: AgentMesh) -> list:
    """Each shard's validity: a resident window's global ``(lo, hi)``
    becomes each shard's own ``(lo, hi)`` as Python ints (the fragment
    builds the mask, ``exec/fragment.py`` ``_range_valid``); a staged
    window's mask splits like the planes."""
    if isinstance(valid, tuple):
        lo, hi = int(valid[0]), int(valid[1])
        out = []
        for start, stop in shard_bounds(n, mesh.devices.size):
            size = stop - start
            out.append((min(max(lo - start, 0), size),
                        min(max(hi - start, 0), size)))
        return out
    return row_shards(valid, mesh)


def _shard_inputs(cols, valid, mesh: AgentMesh, side_on=None):
    """Per slot: ``(device, shard cols, shard valid)``. ``side_on(dev)``
    gives the fused join's side tables on a slot's device."""
    cols = dict(cols)
    side = cols.pop("__side__", None)
    planes0 = [p for ps in cols.values() for p in ps]
    n = planes0[0].shape[0] if planes0 else valid.shape[0]
    split = {c: [row_shards(p, mesh) for p in planes]
             for c, planes in cols.items()}
    valids = shard_valid(valid, n, mesh)
    out = []
    for i, dev in enumerate(mesh.slots):
        scols = {c: tuple(parts[i] for parts in planes)
                 for c, planes in split.items()}
        if side:
            scols["__side__"] = side_on(dev) if side_on is not None else side
        out.append((dev, scols, valids[i]))
    return out


def _frag_on(frag, frags, dev):
    return frags.get(dev, frag) if frags else frag


def distributed_agg_step(frag, mesh: AgentMesh, state, cols, valid,
                         frags: dict | None = None, side_on=None):
    """Fold one window over the mesh into the running ``state``: each
    slot runs the fragment's ``window_state`` on its row shard, the
    states tree-merge over ``agents`` (within each ``kelvin`` row),
    then over ``kelvin`` when the mesh has more than one row, then merge
    into ``state``. ``frags`` maps a slot device to the fragment
    compiled for it (default: ``frag`` everywhere)."""
    n_kelvin, n_agents = mesh.devices.shape
    local = [
        _frag_on(frag, frags, dev).window_state(scols, svalid)
        for dev, scols, svalid in _shard_inputs(cols, valid, mesh, side_on)
    ]
    rows = [
        _axis_fold_merge(local[k * n_agents:(k + 1) * n_agents],
                         frag.merge_states)
        for k in range(n_kelvin)
    ]
    merged = _axis_fold_merge(rows, frag.merge_states) if n_kelvin > 1 \
        else rows[0]
    dev = _state_device(state)
    return frag.merge_states(state, merged if dev is None
                             else _tree_to(merged, dev))


def _cat(planes: list) -> torch.Tensor:
    if planes[0].dtype == torch.uint64:
        # Few uint64 kernels exist on CUDA: concatenate the int64 view.
        return torch.cat([p.view(torch.int64) for p in planes]).view(
            torch.uint64
        )
    return torch.cat(planes)


def distributed_rows_step(frag, mesh: AgentMesh, cols, valid,
                          frags: dict | None = None, side_on=None):
    """Run a row chain over the mesh: each slot runs the fragment's
    ``update`` on its row shard, and the shards' outputs and valid masks
    concatenate in shard order on the first slot's device, so the rows
    come out in the single engine's order."""
    dev0 = mesh.slots[0]
    outs = [
        _frag_on(frag, frags, dev).update(scols, svalid)
        for dev, scols, svalid in _shard_inputs(cols, valid, mesh, side_on)
    ]
    out_cols = {
        name: tuple(
            _cat([_tree_to(o[0][name][j], dev0) for o in outs])
            for j in range(len(planes))
        )
        for name, planes in outs[0][0].items()
    }
    return out_cols, _cat([_tree_to(o[1], dev0) for o in outs])


class DistributedEngine(Engine):
    """An engine whose window folds run over a mesh of virtual PEMs.

    Joins and unions still reduce on the first slot (they consume
    post-aggregate, small inputs); every per-row fragment and every
    partial-aggregate merge runs over the mesh. The engine's own
    ``device`` is the mesh's first slot: tables stage their windows
    there, and a window's row shards are views of its planes on every
    slot that shares that device.

    With a ``distributed_state``, each query is replanned against the
    live agents first (the reference pulls the DistributedState per
    query): when the coordinator prunes agents, the query runs on a
    degraded sub-mesh of the first ``n_data_shards`` slots. The
    executing mesh is per query (thread-local), so a query on another
    thread keeps its own.
    """

    def __init__(self, registry=None, window_rows: int | None = None,
                 mesh: AgentMesh | None = None, n_agents: int | None = None,
                 n_kelvin: int = 1, distributed_state=None):
        mesh = mesh if mesh is not None else agent_mesh(n_agents, n_kelvin)
        super().__init__(registry=registry, window_rows=window_rows,
                         device=mesh.slots[0])
        self._base_mesh = mesh
        self.distributed_state = distributed_state
        self.last_distributed_plan = None
        # Serializes the replan (planner state, last_distributed_plan).
        self._exec_guard = threading.RLock()
        # Per fragment (by id): the fragment compiled for each other
        # slot device; per fused side table (by id): its copies there.
        self._frags_on: dict = {}
        self._side_on: dict = {}

    @property
    def mesh(self) -> AgentMesh:
        """The executing mesh: the running query's on its own thread (a
        degraded sub-mesh after a replan), else the base mesh."""
        return getattr(self._tls, "mesh", None) or self._base_mesh

    @property
    def n_devices(self) -> int:
        """Slots of the executing mesh (a slot is a virtual PEM, so two
        may share a card)."""
        return int(self.mesh.devices.size)

    @property
    def device_residency(self) -> bool:
        """Windows staged at append time are read as they are on the
        base mesh. A degraded-mesh query stages each window instead, as
        the JAX engine does (its resident windows' shard layout differs
        there), so its ``last_stats`` counts staged windows."""
        return self.mesh is self._base_mesh

    def execute_plan(self, plan, bridge_inputs=None, analyze=False,
                     materialize=True, cancel=None, trace=None):
        """Replan against the live agent set, then execute on the mesh
        the plan leaves: the base mesh, or the sub-mesh of its first
        ``n_data_shards`` slots when agents were pruned. Bridges are
        stitched against that executing mesh."""
        if self.distributed_state is None:
            return super().execute_plan(
                plan, bridge_inputs=bridge_inputs, analyze=analyze,
                materialize=materialize, cancel=cancel, trace=trace,
            )

        from ..planner.distributed import DistributedPlanner
        from ..planner.distributed.coordinator import PlanningError

        with self._exec_guard:
            planner = DistributedPlanner()
            try:
                split = planner.splitter.split(plan)
                dplan = planner.coordinator.assign(
                    split, self.distributed_state
                )
            except PlanningError as e:
                raise QueryError(str(e)) from e
            base = self._base_mesh
            n_kelvin = base.devices.shape[0]
            max_agents = base.devices.size // n_kelvin
            n_shards = min(dplan.n_data_shards or max_agents, max_agents)
            mesh = base if n_shards >= max_agents else agent_mesh(
                n_shards, n_kelvin, devices=base.slots
            )
            planner.stitch(dplan, self.distributed_state, mesh=mesh)
            self.last_distributed_plan = dplan
        prev = getattr(self._tls, "mesh", None)
        self._tls.mesh = mesh
        try:
            return super().execute_plan(
                plan, bridge_inputs=bridge_inputs, analyze=analyze,
                materialize=materialize, cancel=cancel, trace=trace,
            )
        finally:
            self._tls.mesh = prev

    def _staged_windows(self, stream, stats, cancel):
        """The base engine's windows, read under this query's mesh: the
        pipeline's prefetch thread runs the generator, and it must see a
        degraded mesh (no resident windows) as the query thread does."""
        mesh = self.mesh
        windows = super()._staged_windows(stream, stats, cancel)

        def on_mesh():
            while True:
                prev = getattr(self._tls, "mesh", None)
                self._tls.mesh = mesh
                try:
                    item = next(windows, None)
                finally:
                    self._tls.mesh = prev
                if item is None:
                    return
                yield item

        return on_mesh()

    # -- fragments and side tables on the other slot devices ------------------
    def _other_devices(self) -> list:
        return [d for d in self._base_mesh.distinct_devices()
                if d != self.device]

    def _compile(self, stream):
        """The stream's fragment on the first slot, and on each other
        slot device a twin compiled against the same column stats (so
        every slot's dense domains agree)."""
        others = self._other_devices()
        if not others:
            return super()._compile(stream)
        col_stats = _stream_col_stats(stream)

        def on(dev):
            return compile_fragment(
                stream.chain, stream.relation, stream.dicts, self.registry,
                dev, col_stats=col_stats,
            )

        frag = on(self.device)
        key = id(frag)
        self._frags_on[key] = {d: on(d) for d in others}
        weakref.finalize(frag, self._frags_on.pop, key, None)
        return frag

    def _put_side(self, v):
        """A fused join's side table on the first slot, with a copy on
        each other slot device, made once per query."""
        t = super()._put_side(v)
        others = self._other_devices()
        if others:
            key = id(t)
            self._side_on[key] = {d: t.to(d) for d in others}
            weakref.finalize(t, self._side_on.pop, key, None)
        return t

    def _side_for(self, side: dict):
        def side_on(dev):
            if dev == self.device:
                return side
            return {k: self._side_on.get(id(t), {}).get(dev, t)
                    for k, t in side.items()}
        return side_on

    def _compile_steps(self, frag):
        """The base engine's steps, run over the executing mesh."""
        mesh = self.mesh
        frags = self._frags_on.get(id(frag))

        def side_on_of(cols):
            side = cols.get("__side__")
            return self._side_for(side) if side else None

        if frag.is_agg:
            def agg_step(state, cols, valid):
                return distributed_agg_step(
                    frag, mesh, state, cols, valid, frags,
                    side_on_of(cols),
                )

            return frag.init_state, agg_step, None

        def rows_step(cols, valid):
            return distributed_rows_step(
                frag, mesh, cols, valid, frags, side_on_of(cols)
            )

        return None, None, rows_step

