"""Multi-host stream processing over ``jax.distributed``.

One process per host, SPMD: every process builds the SAME global
``Mesh`` over ``jax.devices()`` (which spans all hosts once
``jax.distributed`` is initialized) and runs the SAME jitted step.  Each
process feeds frames only for the streams that live on ITS devices;
cross-host traffic is exactly the step's collectives (the global-stats
``psum``), which XLA hands to the platform's collective library.  This is
the standard JAX multi-process recipe — no per-host rank logic in the
compute path (the reference is strictly single-process, SURVEY.md §2
parallelism inventory; this layer is beyond-parity scale-out).

Deployment shape (one command per host)::

    # a cluster manager JAX can detect (e.g. Slurm): nothing to pass
    python my_app.py

    # otherwise: pass coordinator + rank explicitly
    python my_app.py --coordinator host0:9876 --nprocs 4 --rank $RANK

with ``init_multihost()`` called before any other JAX use, then
``MultiHostStreamEngine`` in place of ``MultiStreamEngine``.

SPMD discipline (the engine enforces what it can and documents the rest):
every process must call ``process_batch`` (and ``load_state_dict`` /
``reset``) the SAME NUMBER OF TIMES — the jitted step contains
collectives, and a process that skips a call deadlocks the mesh.
Per-round frame counts may differ between hosts (the device program is
batch-padded and masks invalid slots), and a host whose cameras all
stalled passes an all-empty feed: it still enters the step, masked
invalid.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .multistream import MultiStreamEngine, stream_mesh

log = logging.getLogger("dips.multihost")

#: a no-arg init_multihost() that found no cluster sticks with the
#: single-process topology for the life of the process (its own topology
#: accessors initialize the backend, which makes later auto-detection
#: attempts impossible anyway)
_single_process = False

__all__ = ["init_multihost", "MultiHostInfo", "MultiHostStreamEngine"]


@dataclass(frozen=True)
class MultiHostInfo:
    """What this process looks like inside the cluster."""
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> MultiHostInfo:
    """Join (or form) a multi-host JAX cluster.

    Under a cluster manager JAX can detect, call it with no arguments —
    every parameter is auto-detected.  Otherwise pass the coordinator's
    ``host:port``, the total process count, and this process's rank.
    Must run before any other JAX API touches a backend (this function
    itself touches none before initializing).
    Idempotent: calling it in an already-initialized (or single-process,
    no-arg non-cluster) context just returns the topology.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    global _single_process
    if jax.distributed.is_initialized():
        pass  # idempotent re-call: report the live topology
    elif kwargs:
        jax.distributed.initialize(**kwargs)
    elif _single_process:
        pass  # an earlier no-arg call already settled on single-process
    else:
        # cluster auto-detection (Slurm, ...).  Deliberately NO
        # backend probe here — e.g. jax.default_backend() would initialize
        # XLA and make jax.distributed.initialize() unusable.  An
        # environment with no detectable cluster is a plain single
        # process: fall back to the trivial topology.  ONLY the
        # nothing-detected error falls back — a detected cluster whose
        # join fails (coordinator unreachable, timeout) must raise, or
        # this worker would run process_count=1 and deadlock its peers
        # in the first collective.
        try:
            jax.distributed.initialize()
        except ValueError as e:
            if "coordinator_address" not in str(e):
                raise
            _single_process = True
            log.info("no cluster auto-detected: single-process topology")
        except RuntimeError as e:
            if "before any JAX calls" not in str(e):
                raise
            # a backend is already live, so auto-detection is off the
            # table for the rest of this process; explicit kwargs would
            # still raise above.  On a cluster this call came too late —
            # say so loudly instead of deadlocking silently.
            _single_process = True
            log.warning(
                "init_multihost() called after a JAX backend was already "
                "initialized: cluster auto-detection is unavailable, "
                "continuing single-process.  On a multi-host deployment "
                "call init_multihost() before any other JAX use.")
    return MultiHostInfo(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_device_count=jax.local_device_count(),
        global_device_count=jax.device_count(),
    )


class MultiHostStreamEngine(MultiStreamEngine):
    """``MultiStreamEngine`` over a GLOBAL device mesh spanning processes.

    ``n_streams`` is the GLOBAL stream count.  Each process:

    * owns the streams sharded onto its local devices
      (:attr:`local_stream_ids`, a contiguous block in mesh order);
    * passes ``process_batch`` a full ``n_streams``-long list in which
      only ITS streams carry frames (remote entries: empty lists — they
      are ignored here and fed by their owning process);
    * gets back outputs/stats for its LOCAL streams only (leading axis
      ``len(local_stream_ids)``, in :attr:`local_stream_ids` order) —
      remote pixels never cross hosts, only the psum'd global scalar does;
    * checkpoints its LOCAL shard (``state_dict``/``save`` are per-host,
      one file per process — restore each on its own host).

    The step runs through the global-array plumbing: carried
    baseline/heatmap state lives in global arrays (the multi-chip dry run,
    _dryrun.py step 1b, exercises it).

    Not available in this mode (all would need eager ops on global
    arrays or break SPMD lockstep): ``input_layout="hwc"``,
    ``packed_wire``, and the per-stream device-state surgeries
    ``reset_stream`` / ``load_stream_state`` / ``save_stream`` /
    ``load_stream`` (use the per-host checkpoint instead; ``revive`` and
    ``snapshot`` are host-side and work).
    """

    _lockstep_collectives = True  # every process must enter every step

    def __init__(self, props, height: int, width: int, n_streams: int,
                 batch: int = 8, mesh: Optional[Mesh] = None):
        if mesh is None:
            mesh = stream_mesh()  # jax.devices() is global under jax.distributed
        if "rows" in mesh.axis_names:
            # Reasoned restriction, not a stub (cf. _no_multihost below):
            # on a 2-D (stream x rows) mesh one FRAME's rows span devices
            # on different hosts, so the host that decodes a frame would
            # have to scatter row slabs to remote processes before the
            # step — a cross-host transfer per frame that the "each process
            # feeds only its local streams" contract (and
            # make_array_from_single_device_arrays, which only accepts
            # addressable shards) cannot express.  Clusters scale by WHOLE
            # streams: use a 1-D stream mesh here, and row-shard big
            # frames within a single host's devices (MultiStreamEngine
            # on a grid mesh, parallel/grid2d.py).
            raise ValueError(
                "MultiHostStreamEngine needs a 1-D stream mesh: a row-"
                "sharded frame would span hosts, and the feeding host "
                "cannot contribute non-addressable (remote) row slabs "
                "to the global array.  Shard streams across hosts here; "
                "row-shard within one host via MultiStreamEngine on a "
                "grid mesh.")
        n_dev = int(mesh.devices.size)
        if n_streams % n_dev:
            raise ValueError(
                f"n_streams={n_streams} must be a multiple of the global "
                f"device count {n_dev}")
        rows_per_dev = n_streams // n_dev
        # mesh order defines stream ownership: device k holds streams
        # [k*rpd, (k+1)*rpd).  Local devices in mesh order -> this
        # process's contiguous-by-device stream ids.
        me = jax.process_index()
        flat = list(mesh.devices.flat)
        self._local_dev_rows: List[tuple] = [
            (d, k * rows_per_dev) for k, d in enumerate(flat)
            if d.process_index == me]
        if not self._local_dev_rows:
            raise ValueError("this process has no devices in the mesh")
        self._rows_per_dev = rows_per_dev
        self.local_stream_ids: List[int] = [
            row + i for _, row in self._local_dev_rows
            for i in range(rows_per_dev)]
        self._row_of = {si: k for k, si in enumerate(self.local_stream_ids)}
        self._mesh_for_sharding = mesh
        super().__init__(props, height, width, n_streams, batch=batch,
                         mesh=mesh)

    # -- global-array plumbing ----------------------------------------------
    def _sharding(self, ndim: int) -> NamedSharding:
        return NamedSharding(self._mesh_for_sharding, P("stream"))

    def _zeros(self, shape, dtype):
        sh = self._sharding(len(shape))
        return jax.make_array_from_callback(
            tuple(shape), sh,
            lambda idx: np.zeros(
                tuple(len(range(*s.indices(shape[i])))
                      for i, s in enumerate(idx)), dtype))

    def _to_device(self, x):
        """Lift a LOCAL staging buffer (leading axis = this process's
        streams, in ``local_stream_ids`` order) into the global array —
        remote rows are fed by their owning processes."""
        x = np.asarray(x)
        if x.shape[0] != self.n_local_streams:
            raise ValueError(
                f"staging buffer has {x.shape[0]} rows, expected the "
                f"{self.n_local_streams} local streams")
        gshape = (self.n_streams,) + x.shape[1:]
        sh = self._sharding(x.ndim)
        rpd = self._rows_per_dev
        shards = [
            jax.device_put(np.ascontiguousarray(x[k * rpd:(k + 1) * rpd]),
                           d)
            for k, (d, _) in enumerate(self._local_dev_rows)]
        return jax.make_array_from_single_device_arrays(gshape, sh, shards)

    def _fetch(self, x, n: Optional[int] = None):
        """Read back this process's rows only, in local_stream_ids order."""
        by_row = {}
        for s in x.addressable_shards:
            start = s.index[0].start or 0
            by_row[start] = np.asarray(s.data)
        a = np.concatenate([by_row[k] for k in sorted(by_row)], axis=0)
        return a if n is None else a[:, :n]

    # -- host staging: this process's streams only ---------------------------
    def _stage_rows(self) -> int:
        return self.n_local_streams

    def _stage_index(self, si: int) -> int:
        return self._row_of.get(si, -1)

    def _stage_gather(self, seq) -> np.ndarray:
        return np.asarray([seq[i] for i in self.local_stream_ids])

    # -- local-shard views ----------------------------------------------------
    @property
    def n_local_streams(self) -> int:
        return len(self.local_stream_ids)

    def local_frames_template(self) -> list:
        """A ``process_batch``-shaped list: empty per-stream slots, fill
        only ``local_stream_ids`` entries."""
        return [[] for _ in range(self.n_streams)]

    # -- per-host checkpointing ----------------------------------------------
    def state_dict(self) -> dict:
        """This process's shard: local stream rows + their host cursors.
        Save one per host; restore each on its own host."""
        ids = self.local_stream_ids
        return {
            "local_stream_ids": list(ids),
            "frame_cursors": [self.frame_cursors[i] for i in ids],
            "baseline": self._fetch(self._baseline),
            "heatmap": self._fetch(self._heatmap),
            "tails": [np.stack(self._tails[i])
                      if self._tails[i] is not None else None for i in ids],
            "failed": sorted(i for i in self.failed if i in set(ids)),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore this process's shard (every process restores its own
        file)."""
        from ..errors import StreamError
        ids = list(state.get("local_stream_ids", self.local_stream_ids))
        if ids != self.local_stream_ids:
            raise ValueError(
                f"checkpoint holds streams {ids}, this process owns "
                f"{self.local_stream_ids} (restore each host's own file)")
        bl = np.asarray(state["baseline"])
        n_l = self.n_local_streams
        expect = ((n_l, 3, self.hp, self.wp) if self._raw_mode
                  else (n_l, self.hp, self.wp))
        if bl.shape != expect:
            raise ValueError(
                f"checkpoint baseline shape {bl.shape} != local shard "
                f"shape {expect}")
        self._baseline = self._to_device(bl)
        self._heatmap = self._to_device(np.asarray(state["heatmap"]))
        for i, si in enumerate(ids):
            self.frame_cursors[si] = int(state["frame_cursors"][i])
            tl = state["tails"][i]
            self._tails[si] = ([np.asarray(f) for f in tl]
                               if tl is not None else None)
            self._snap_pending[si] = False
        self.failed = {
            int(si): StreamError(int(si),
                                 RuntimeError("restored from checkpoint"))
            for si in state.get("failed", ())}

    def save(self, path: str) -> None:
        """Per-host checkpoint (append the process index to ``path`` when
        hosts share a filesystem)."""
        s = self.state_dict()
        t = self.props.temporal_size
        tails = np.stack([
            tl if tl is not None else np.zeros((t, 3, self.hp, self.wp),
                                               np.uint8)
            for tl in s["tails"]])
        has_tail = np.asarray([tl is not None for tl in s["tails"]])
        np.savez_compressed(
            path, local_stream_ids=np.asarray(s["local_stream_ids"]),
            frame_cursors=np.asarray(s["frame_cursors"]),
            baseline=s["baseline"], heatmap=s["heatmap"], tails=tails,
            has_tail=has_tail, failed=np.asarray(s["failed"], np.int64))

    def load(self, path: str) -> None:
        with np.load(path) as z:  # NpzFile holds an fd until closed
            self.load_state_dict({
                "local_stream_ids": z["local_stream_ids"].tolist(),
                "frame_cursors": z["frame_cursors"].tolist(),
                "baseline": z["baseline"],
                "heatmap": z["heatmap"],
                "tails": [z["tails"][i] if z["has_tail"][i] else None
                          for i in range(z["tails"].shape[0])],
                "failed": z["failed"].tolist(),
            })

    # -- unsupported in multi-host mode ---------------------------------------
    def _no_multihost(self, name: str):
        raise NotImplementedError(
            f"{name} mutates one stream's device state eagerly, which is "
            "not possible on a multi-host global array; use the per-host "
            "checkpoint (state_dict/save/load) instead")

    def reset_stream(self, stream: int) -> None:
        self._no_multihost("reset_stream")

    def stream_state_dict(self, stream: int) -> dict:
        self._no_multihost("stream_state_dict")

    def load_stream_state(self, stream: int, state: dict) -> None:
        self._no_multihost("load_stream_state")

    def save_stream(self, stream: int, path: str) -> None:
        self._no_multihost("save_stream")

    def load_stream(self, stream: int, path: str) -> None:
        self._no_multihost("load_stream")
