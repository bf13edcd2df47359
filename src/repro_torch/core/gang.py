"""Gang-consistent snapshots of multi-VM jobs: quiesce → drain → commit.

The paper's service claims support for "parallel and distributed
computations (e.g. over TCP or InfiniBand)", but a snapshot taken from one
coordinator is only consistent for one VM. This module supplies the
missing distributed cut, following the DMTCP coordinator protocol:

    phase QUIESCE  every rank is paused at an iteration boundary (no rank
                   is mid-send), acknowledged under a per-rank ack timeout
                   with bounded retry/backoff on ``active_clock()``;
    phase DRAIN    with all ranks paused the fabric's in-flight counters
                   are frozen; each rank's channel is drained and the
                   messages become part of the snapshot (channel state),
                   not of any rank's memory — the Chandy-Lamport marker
                   rule made concrete;
    phase SAVE     per-rank shards stream through the parallel data plane
                   into ONE gang image (ckpt/gang.py) …
    phase COMMIT   … which becomes visible atomically with a single
                   COMMITTED marker. All-or-nothing: any rank crash,
                   partition, straggler timeout or storage fault anywhere
                   before the marker aborts the epoch, releases every
                   rank, and leaves the previous committed image
                   untouched.

Every phase boundary probes every rank over the message transport itself
(``channel_probe``): a dead or partitioned rank fails the probe rather
than the barrier hanging on an ack that cannot arrive.

The demo workload (``GangApp``) is an N-rank message-passing computation
whose state carries its own consistency proof: column 1 of the global
state counts messages *sent* from each row, column 0 counts messages
*applied* to each row, and a cut is consistent iff

    sum(state[:,1]) == sum(state[:,0]) + rows(inbox)

— a lost or duplicated in-flight message breaks the equality
(``gang_invariant``). Restore reshards to any rank count: shards are
re-split by ``even_regions`` and drained messages are re-routed to the
rank that owns their target row under the new partition.

Port of ``repro/core/gang.py``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.clusters.simulator import TIME_SCALE, ChannelError, sim_sleep
from repro_torch.obs.trace import tracer
from repro_torch.sharding.specs import even_regions
from repro_torch.sim.simtime import active_clock

# Leaf layout of a GangApp snapshot (what save_gang_image receives).
GANG_SHARDED = {"state": 0}
GANG_ROUTED = {"inbox": {"by": "state", "col": 2, "cols": 4}}
STATE_COLS = 2           # col 0: messages applied, col 1: messages sent


class GangBarrierError(RuntimeError):
    """A gang epoch aborted; ``reason`` is the replay-stable cause tag."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class GangStragglerError(GangBarrierError):
    def __init__(self, msg: str):
        super().__init__(msg, "straggler")


@dataclasses.dataclass(frozen=True)
class BarrierConfig:
    """Fault-tolerance knobs of the two-phase barrier.

    All durations are PAPER-calibrated seconds, the same axis as
    ``GangApp.iter_time_s`` and every simulator cost — so "a rank that
    cannot ack within ~3 iterations is a straggler" stays true under both
    the wall clock and the virtual clock."""
    ack_timeout_s: float = 1.0       # per-rank quiesce-ack wait
    ack_retries: int = 2             # extra waits before declaring straggler
    backoff_s: float = 0.25          # grows linearly per retry


class _Rank:
    """One rank's in-process runtime: state shard + worker thread."""

    def __init__(self, idx: int, vm: Any, row_off: int, n_rows: int):
        self.idx = idx
        self.vm = vm
        self.host_id = vm.host.host_id
        self.row_off = row_off
        self.state = np.zeros((n_rows, STATE_COLS), np.float64)
        self.iteration = 0
        self.seq = 0                         # per-rank send counter
        self.send_failures = 0
        self.lock = threading.Lock()
        self.pause_req = threading.Event()
        self.paused_evt = threading.Event()
        self.release_evt = threading.Event()
        self.pending: List[Tuple] = []       # drained, not yet applied
        self.thread: Optional[threading.Thread] = None

    def apply_rows(self, rows: Sequence[Sequence[float]]) -> None:
        """Deliver message rows (src, seq, dst_row, value) to this shard."""
        with self.lock:
            for m in rows:
                local = int(m[2]) - self.row_off
                if 0 <= local < self.state.shape[0]:
                    self.state[local, 0] += float(m[3])


class GangApp:
    """N-rank message-passing workload over the simulated fabric.

    Implements the ``Application`` protocol so AppManager hosts it like any
    job. The *global* problem size (``global_rows``) is fixed at submission;
    each start splits it over however many VMs the context carries
    (``even_regions``), which is what makes shrink-restore onto fewer
    survivors work without the app noticing.

    Every iteration a rank: delivers received messages, pays ``iter_time_s``
    (scaled by its host's slowdown — stragglers emerge naturally), and
    sends one message to the next rank targeting one of its peer's rows.
    """

    device = torch.device("cpu")          # numpy rank state, on the host

    def __init__(self, global_rows: int = 16, n_iters: int = 1_000_000,
                 iter_time_s: float = 0.05,
                 barrier: Optional[BarrierConfig] = None):
        self.global_rows = global_rows
        self.n_iters = n_iters
        self.iter_time_s = iter_time_s
        self.barrier = barrier or BarrierConfig()
        self.ranks: List[_Rank] = []
        self.transport: Any = None
        self.ctx: Any = None
        self.restarts = 0
        self._stop = threading.Event()
        self._poisoned = False

    # -- Application protocol -------------------------------------------
    def start(self, ctx: Any, restore_state: Optional[Any]) -> None:
        self.ctx = ctx
        self.transport = getattr(ctx, "transport", None) or self.transport
        if self.transport is None:
            raise ValueError("GangApp needs a message transport "
                             "(ctx.transport; set by AppManager on "
                             "simulated backends)")
        n = len(ctx.vms)
        if n < 1:
            raise ValueError("GangApp needs at least one VM")
        if restore_state is not None and len(restore_state) != n:
            raise ValueError(f"restore carries {len(restore_state)} rank "
                             f"trees for {n} VMs")
        self._stop.clear()
        self._poisoned = False
        regions = even_regions(self.global_rows, n)
        self.ranks = []
        for r, (off, length) in enumerate(regions):
            rk = _Rank(r, ctx.vms[r], off, length)
            if restore_state is not None:
                tree = restore_state[r]
                rk.state = np.array(tree["state"], np.float64).reshape(
                    length, STATE_COLS)
                rk.iteration = int(tree["iteration"])
                # in-flight messages of the cut are *delivered* on restore:
                # applying them here is the receive the crash interrupted
                rk.apply_rows(np.asarray(tree.get("inbox", ()),
                                         np.float64).reshape(-1, 4))
            self.ranks.append(rk)
        if restore_state is not None:
            self.restarts += 1
        for rk in self.ranks:
            self.transport.channel_open(rk.host_id)
        for rk in self.ranks:
            rk.thread = threading.Thread(target=self._run_rank, args=(rk,),
                                         daemon=True)
            rk.thread.start()

    def _run_rank(self, rk: _Rank) -> None:
        clk = active_clock()
        n = len(self.ranks)
        while not self._stop.is_set():
            if rk.pause_req.is_set():        # quiesced at a boundary —
                rk.paused_evt.set()          # never mid-send
                while rk.pause_req.is_set() and not self._stop.is_set():
                    # paper-calibrated poll (×TIME_SCALE wall → 1 virtual
                    # second): a wall-tuned timeout here would race virtual
                    # time forward 200s per wake while the save phase does
                    # CPU-bound upload work, dwarfing the real barrier cost
                    clk.wait(rk.release_evt, 1.0 * TIME_SCALE)
                rk.paused_evt.clear()
                rk.release_evt.clear()
                continue
            if rk.iteration >= self.n_iters:
                clk.wait(rk.pause_req, 0.5)  # done: stay barrier-responsive
                continue
            rk.apply_rows(self.transport.channel_recv(rk.host_id))
            sim_sleep(self.iter_time_s * rk.vm.host.slowdown)
            if n > 1:
                peer = self.ranks[(rk.idx + 1) % n]
                dst_row = peer.row_off + rk.iteration % peer.state.shape[0]
                msg = (float(rk.idx), float(rk.seq), float(dst_row), 1.0)
                try:
                    self.transport.channel_send(rk.host_id, peer.host_id,
                                                msg)
                except ChannelError:
                    rk.send_failures += 1    # peer dead: message dropped
                else:                        # BEFORE it was ever in flight,
                    with rk.lock:            # so the sent-ledger (col 1)
                        src = rk.iteration % rk.state.shape[0]   # skips it
                        rk.state[src, 1] += 1.0
                    rk.seq += 1
            rk.iteration += 1

    def checkpoint_state(self) -> Dict[str, Any]:
        """Protocol fallback (NOT gang-consistent — use GangCoordinator)."""
        return {"iteration": self.min_iteration()}

    def healthy(self) -> bool:
        return not self._poisoned

    def stop(self) -> None:
        self._stop.set()
        for rk in self.ranks:
            rk.release_evt.set()
            if rk.thread is not None:
                rk.thread.join(timeout=5)
        if self.transport is not None:
            for rk in self.ranks:
                try:
                    self.transport.channel_close(rk.host_id)
                except Exception:
                    pass

    def is_done(self) -> bool:
        return bool(self.ranks) and self.min_iteration() >= self.n_iters

    def progress(self) -> float:
        return self.min_iteration() / max(self.n_iters, 1)

    # -- helpers ---------------------------------------------------------
    def min_iteration(self) -> int:
        return min((rk.iteration for rk in self.ranks), default=0)

    def poison(self) -> None:
        self._poisoned = True


def gang_invariant(rank_trees: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """Conservation check of a gang cut: every message ever sent is either
    applied to some row or sitting in some rank's drained inbox."""
    sent = applied = inflight = 0.0
    for t in rank_trees:
        st = np.asarray(t["state"], np.float64).reshape(-1, STATE_COLS)
        applied += float(st[:, 0].sum())
        sent += float(st[:, 1].sum())
        inflight += float(np.asarray(t.get("inbox", ()),
                                     np.float64).reshape(-1, 4)[:, 3].sum())
    return {"sent": sent, "applied": applied, "inflight": inflight,
            "consistent": float(sent == applied + inflight)}


class GangCoordinator:
    """Drives the fault-tolerant two-phase barrier over one GangApp.

    ``save_fn(step, rank_trees) -> manifest`` is the storage half
    (CheckpointManager.save_gang) — this class owns only the protocol.

    Chaos hooks: ``arm(phase, fn)`` registers a one-shot action executed
    deterministically when the barrier ENTERS that phase ("quiesce" /
    "drain" / "save" / "commit") — fault injection keyed to protocol
    position, not to a timing race, which is what makes the seeded chaos
    scenarios replay bit-for-bit.

    The barrier trace records wall-free tuples for the same reason.
    """

    PHASES = ("quiesce", "drain", "save", "commit")

    def __init__(self, app: GangApp, transport: Any,
                 save_fn: Callable[[int, List[Dict[str, Any]]], Any],
                 trace_id: str = ""):
        self.app = app
        self.transport = transport
        self.save_fn = save_fn
        self.trace_id = trace_id
        self.cfg = app.barrier
        self.epochs_started = 0
        self.epochs_committed = 0
        self.aborts = 0
        self.last_abort_reason: Optional[str] = None
        self._trace: List[tuple] = []
        self._armed: Dict[str, List[Callable[[], None]]] = {}
        self._lock = threading.Lock()

    def rebind(self, app: GangApp, transport: Any) -> None:
        """Point at the restarted app instance (same job, new VMs)."""
        self.app = app
        self.transport = transport
        self.cfg = app.barrier

    def arm(self, phase: str, fn: Callable[[], None]) -> None:
        if phase not in self.PHASES:
            raise ValueError(f"unknown barrier phase {phase!r}")
        self._armed.setdefault(phase, []).append(fn)

    def barrier_trace(self) -> List[tuple]:
        with self._lock:
            return list(self._trace)

    def _tr(self, step: int, tag: str, detail: str = "") -> None:
        """Append one wall-free trace tuple and mirror it into the span
        tracer. The local list stays the replay-exact source of truth
        (the tracer has a drop cap; barrier_trace() must not)."""
        self._trace.append((self.trace_id, step, tag, detail))
        tracer().event(f"gang/{tag}", cat="gang", trace_id=self.trace_id,
                       args={"step": step, "detail": detail})

    def stats(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id,
                "epochs_started": self.epochs_started,
                "epochs_committed": self.epochs_committed,
                "aborts": self.aborts,
                "last_abort_reason": self.last_abort_reason}

    # -- protocol --------------------------------------------------------
    def snapshot(self, step: int) -> Any:
        """One gang epoch. Returns the committed manifest, or raises
        GangBarrierError having released every surviving rank; a failed
        epoch leaves the previous committed image untouched (the commit
        marker is the only externally-visible effect)."""
        with self._lock, tracer().span(
                "gang/epoch", cat="gang", trace_id=self.trace_id,
                args={"step": step}):
            self.epochs_started += 1
            self._tr(step, "begin")
            try:
                with self._phase_span("quiesce", step):
                    self._enter("quiesce", step)
                    self._quiesce(step)
                with self._phase_span("drain", step):
                    self._enter("drain", step)
                    self._drain(step)
                with self._phase_span("save", step):
                    self._enter("save", step)
                    trees = self._collect()
                    manifest = self.save_fn(step, trees)
                with self._phase_span("commit", step):
                    self._enter("commit", step)
                    self.epochs_committed += 1
                    self._tr(step, "committed",
                             f"ranks={len(self.app.ranks)}")
                return manifest
            except GangBarrierError as e:
                self._abort(step, e.reason)
                raise
            except ChannelError as e:
                self._abort(step, "partition_or_crash")
                raise GangBarrierError(str(e), "partition_or_crash") from e
            except Exception as e:
                self._abort(step, "store_fault")
                raise GangBarrierError(str(e), "store_fault") from e
            finally:
                self._release()

    def _phase_span(self, phase: str, step: int):
        return tracer().span(f"gang/{phase}", cat="gang",
                             trace_id=self.trace_id, args={"step": step})

    def _enter(self, phase: str, step: int) -> None:
        self._tr(step, "phase", phase)
        for fn in self._armed.pop(phase, ()):   # one-shot, deterministic
            fn()

    def _probe(self, rk: _Rank) -> None:
        self.transport.channel_probe(rk.host_id)

    def _quiesce(self, step: int) -> None:
        clk = active_clock()
        for rk in self.app.ranks:
            rk.pause_req.set()
        # clk.wait takes wall-tuned timeouts; BarrierConfig is
        # paper-calibrated, so map through TIME_SCALE exactly like
        # sim_sleep does (under a SimClock the two cancel into virtual
        # seconds; under the wall clock they compress identically)
        for rk in self.app.ranks:
            for attempt in range(self.cfg.ack_retries + 1):
                acked = clk.wait(rk.paused_evt,
                                 self.cfg.ack_timeout_s * TIME_SCALE)
                # probe AFTER the wait: an in-process ack from a rank the
                # fabric can't reach is not an ack (partition semantics)
                self._probe(rk)
                if acked:
                    self._tr(step, "ack", f"r{rk.idx}/{attempt}")
                    break
                self._tr(step, "retry", f"r{rk.idx}/{attempt}")
                sim_sleep(self.cfg.backoff_s * (attempt + 1))
            else:
                raise GangStragglerError(
                    f"rank {rk.idx} missed {self.cfg.ack_retries + 1} "
                    f"quiesce acks of {self.cfg.ack_timeout_s}s")

    def _drain(self, step: int) -> None:
        # every rank is paused ⇒ the in-flight set is frozen; whatever is
        # in a channel now belongs to the cut as channel state
        for rk in self.app.ranks:
            self._probe(rk)
            rows = sorted(tuple(m) for m in
                          self.transport.channel_recv(rk.host_id))
            rk.pending = list(rows)
            self._tr(step, "drain", f"r{rk.idx}={len(rows)}")
        left = self.transport.channel_inflight(
            [rk.host_id for rk in self.app.ranks])
        if left:
            raise GangBarrierError(
                f"{left} messages still in flight after drain", "drain")

    def _collect(self) -> List[Dict[str, Any]]:
        it = self.app.min_iteration()
        trees = []
        for rk in self.app.ranks:
            inbox = np.array([list(m) for m in rk.pending],
                             np.float64).reshape(-1, 4)
            with rk.lock:
                trees.append({"state": rk.state.copy(), "iteration": it,
                              "inbox": inbox})
        return trees

    def _abort(self, step: int, reason: str) -> None:
        self.aborts += 1
        self.last_abort_reason = reason
        self._tr(step, "abort", reason)

    def _release(self) -> None:
        # commit or abort, drained messages were RECEIVED off the fabric:
        # deliver them so no message is lost to the live run either
        for rk in self.app.ranks:
            if rk.pending:
                rk.apply_rows(rk.pending)
                rk.pending = []
            rk.pause_req.clear()
            rk.release_evt.set()
