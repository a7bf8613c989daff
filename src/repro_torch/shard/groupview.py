"""Group-local views over a multi-group simulation.

The protocol implementations in :mod:`repro_torch.core` are written against a
single n-replica cluster: replica ids are ``0..n-1``, broadcasts iterate
``range(sim.n)``, cost lookups index by replica id. To run G independent
groups inside ONE discrete-event loop (shared clock, real cross-group
message delays) without touching that code, each group's replicas are
constructed against a :class:`GroupView` — an object that quacks like
``Simulation`` but whose id space is the group's local one:

  * ``n`` / ``replicas()`` describe only this group;
  * outbound local replica ids translate to the group's global id block
    (``group * size + local``); ids outside ``[0, size)`` — clients, or
    explicit global addressing — pass through untouched;
  * inbound messages translate same-group global ids back to local.

Cross-group traffic (shard migration) must therefore address peers by
global id via :meth:`GroupView.post_global` and carry explicit reply
addresses in payloads — ``msg.src`` of a cross-group message is NOT in
the receiver's local namespace.
"""

from __future__ import annotations

from repro_torch.core.simulator import Msg, Node, Simulation
from repro_torch.obs.spans import MappedTracer


class GroupView:
    """One shard group's slice of a multi-group :class:`Simulation`."""

    def __init__(self, root: Simulation, group: int, size: int):
        self.root = root
        self.group = group
        self.size = size
        self.base = group * size
        self.costs = root.costs
        self.seed = root.seed
        self.commit_log = root.commit_log   # shared engine-wide stamp log
        self.read_results = root.read_results   # transport hook (sim: None)
        # protocol code under a view speaks local replica ids — wrap the
        # root tracer (when tracing is on) so recorded events carry global
        # ids, same namespace as the flat engine's trace. Captured at
        # construction like commit_log: attach the tracer to the root
        # engine BEFORE build_group.
        rt = getattr(root, "tracer", None)
        self.tracer = None if rt is None else MappedTracer(rt, self.to_global)

    # -- Simulation-compatible surface (what protocol code touches) ---------

    @property
    def n(self) -> int:
        return self.size

    @property
    def now(self) -> float:
        return self.root.now

    @property
    def striped_ops(self) -> int:
        return self.root.striped_ops

    @striped_ops.setter
    def striped_ops(self, v: int) -> None:
        # engine-wide striping counter (repro_torch.coding): views of every
        # group bump the same root tally, like commit_log
        self.root.striped_ops = v

    def to_global(self, node_id: int) -> int:
        return self.base + node_id if 0 <= node_id < self.size else node_id

    def to_local(self, node_id: int) -> int:
        if self.base <= node_id < self.base + self.size:
            return node_id - self.base
        return node_id

    def replicas(self) -> list[int]:
        return [i for i in range(self.size)
                if (self.base + i) not in self.root.crashed]

    def post(self, msg: Msg) -> None:
        msg.src = self.to_global(msg.src)
        msg.dst = self.to_global(msg.dst)
        self.root.post(msg)

    def post_global(self, msg: Msg) -> None:
        """Post with src/dst already in the global namespace (cross-group
        shard-control traffic)."""
        self.root.post(msg)

    def set_timer(self, node_id: int, delay: float, name: str,
                  payload: dict):
        return self.root.set_timer(self.to_global(node_id), delay, name,
                                   payload)

    def busy(self, node_id: int, seconds: float) -> None:
        self.root.busy(self.to_global(node_id), seconds)

    def note_weight_install(self, t: float, epoch: int, ranking: list,
                            by: int) -> None:
        """Record a weight-view install against the root engine with the
        ranking translated to global ids. Only group 0's installs update
        ``root.weight_view`` (the block symbolic fault selectors resolve
        against — see repro_torch.faults.schedule); every group's installs land
        in ``root.weight_installs`` for RunResult.weight_epochs."""
        g_ranking = [self.to_global(r) for r in ranking]
        g_by = self.to_global(by)
        if self.group == 0:
            self.root.note_weight_install(t, epoch, g_ranking, g_by)
            return
        self.root.weight_installs.append((t, epoch, tuple(g_ranking), g_by))
        tr = getattr(self.root, "tracer", None)
        if tr is not None:
            tr.ev("weight_install", t, g_by, epoch,
                  ",".join(map(str, g_ranking)))


class GroupNodeProxy(Node):
    """Registers a locally-addressed replica in the global simulation under
    its global id, translating same-group ids on delivery."""

    def __init__(self, inner: Node, view: GroupView):
        super().__init__(view.to_global(inner.node_id), view.root)
        self.inner = inner
        self.view = view

    def on_message(self, msg: Msg, now: float) -> None:
        msg.src = self.view.to_local(msg.src)
        msg.dst = self.view.to_local(msg.dst)
        self.inner.on_message(msg, now)

    def on_timer(self, name: str, payload: dict, now: float) -> None:
        self.inner.on_timer(name, payload, now)

    def on_recover(self, now: float) -> None:
        hook = getattr(self.inner, "on_recover", None)
        if hook is not None:
            hook(now)
