"""Multi-hub bus fabric: hub-partitioned buses with host-side routing.

The paper's §4.1 experiment saturates a single USB3 multi-drop bus at
five accelerators: every endpoint shares ONE arbitration domain, so the
per-transfer cost grows with the total device count no matter how the
frames are dispatched.  Past that knee, faster devices do not help —
the topology is the bottleneck.  The fabric is the layer the paper's
"future improvements in bus protocols" points at: partition the devices
across several hubs, each with its *own* calibrated ``SharedBus``
(arbitration scales with the hub's endpoint count, not the fleet's),
and route between hubs through the host.

Three pieces:

  * ``Hub`` — one physical hub: a ``SharedBus`` arbitration domain with
    its own calibrated ``BusParams``.
  * ``InterHubLink`` — the discrete-event host-side channel between a
    hub pair (PCIe root / host-controller path + memcpy): FIFO
    serialized, its own bandwidth and per-transfer overhead, no
    arbitration term (point-to-point).  One full-duplex channel per
    unordered hub pair, created lazily.
  * ``FabricRouter`` — the host-side cost model.  A routed transfer is
    three serialized legs::

        route(src -> dst) = src-hub egress + inter-hub link + dst-hub ingress

    Local transfers (``src == dst``, or only one side given) collapse to
    a single hub-bus transfer, so a one-hub fabric is *identical* to the
    bare ``SharedBus`` — the engine swaps the router in where the bus
    sits today (same ``transfer`` / ``suppress`` / ``stats`` surface).

Suppression at the router.  PR 3's learning: cancelling a hedge loser
*before* its result transfer is what keeps hedging ~free on a shared
medium.  Cross-hub, the stakes are higher — a wasted result would burn
source-hub egress, link time, AND destination-hub ingress, and the
destination hub is where the winning traffic flows.  ``suppress``
therefore kills the route before any leg starts and books the savings
per domain (``suppressed_saved_s`` aggregates hub + link time).  With
``suppression=False`` the router *executes* the wasted route instead
(the loser's result crosses the fabric and is discarded at the host) —
the measurable baseline for what router-level suppression buys
(``benchmarks/fabric_bench.py`` tracks the p99 delta).

Hedge copies are charged to the *destination* hub's bus (ingress-only:
the host already buffers the frame it originally dispatched, so a
speculative re-send consumes no source-hub egress and no inter-hub
link) — otherwise speculative traffic would erode the source hub's
arbitration budget, exactly the failure mode the ROADMAP called out.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.bus.simulator import BusParams, SharedBus


@dataclass
class LinkParams:
    """Host-side routed channel between two hubs.  Defaults model a
    PCIe-root / DMA path: ~3x a hub bus's effective bandwidth and a
    small fixed per-routed-transfer host cost."""
    bandwidth: float = 1.2e9     # effective B/s of the host-side path
    overhead_s: float = 5e-5     # per-transfer routing cost (host CPU)


class InterHubLink:
    """FIFO point-to-point channel between one unordered hub pair.
    Transfers serialize; there is no arbitration term (nothing else
    shares the channel)."""

    def __init__(self, a: int, b: int, params: LinkParams):
        self.a, self.b = (a, b) if a <= b else (b, a)
        self.p = params
        self.reset()

    def reset(self):
        self.free_at = 0.0
        self.up = True
        self.downs = 0
        self.transfers = 0
        self.bytes_moved = 0
        self.busy_s = 0.0
        self.wait_s = 0.0
        self.wire_s = 0.0
        self.suppressed_transfers = 0
        self.suppressed_bytes = 0
        self.suppressed_s = 0.0

    def cost(self, nbytes: int) -> float:
        """Unloaded one-transfer cost (the suppression-savings estimate)."""
        return self.p.overhead_s + nbytes / self.p.bandwidth

    def transfer(self, t_req: float, nbytes: int) -> float:
        if not self.up:
            raise RuntimeError(
                f"link {self.a}<->{self.b} is down; the router must not "
                f"schedule transfers over a dead link")
        start = max(t_req, self.free_at)
        wire = nbytes / self.p.bandwidth
        dur = self.p.overhead_s + wire
        self.free_at = start + dur
        self.transfers += 1
        self.bytes_moved += nbytes
        self.busy_s += dur
        self.wait_s += start - t_req
        self.wire_s += wire
        return self.free_at

    def suppress(self, nbytes: int):
        """Account a routed transfer that never started (hedge loser
        killed at the router)."""
        self.suppressed_transfers += 1
        self.suppressed_bytes += nbytes
        self.suppressed_s += self.cost(nbytes)

    def stats(self) -> dict:
        return {
            "bytes_moved": self.bytes_moved,
            "transfers": self.transfers,
            "busy_s": round(self.busy_s, 6),
            "wait_s": round(self.wait_s, 6),
            "wire_s": round(self.wire_s, 6),
            "suppressed_transfers": self.suppressed_transfers,
            "suppressed_bytes": self.suppressed_bytes,
            "suppressed_s": round(self.suppressed_s, 6),
            "up": self.up,
            "downs": self.downs,
        }


class Hub:
    """One physical hub: its own ``SharedBus`` arbitration domain."""

    def __init__(self, hub_id: int, params: BusParams):
        self.hub_id = hub_id
        self.p = params
        self.bus = SharedBus(params)

    def reset(self):
        self.bus.reset()

    def local_cost(self, nbytes: int) -> float:
        """Unloaded, arbitration-free one-transfer cost on this hub."""
        return self.p.base_overhead_s + nbytes / self.p.bandwidth

    def stats(self) -> dict:
        return self.bus.stats()


LinkSpec = Union[LinkParams, Dict[Tuple[int, int], LinkParams], None]


class FabricRouter:
    """Host-side router over hub-partitioned buses.

    Drop-in for ``SharedBus`` at the ``StreamEngine`` boundary: the
    engine calls the same ``transfer(t, nbytes, n_endpoints)`` /
    ``suppress(nbytes)`` / ``stats()`` surface, optionally extended with
    ``src`` / ``dst`` hub ids (omitted or equal -> a local transfer on
    that hub; a one-hub router is bit-identical to its bare bus).
    ``n_endpoints`` / ``dst_endpoints`` are the *per-hub* endpoint
    counts — partitioning the arbitration domain is the whole point.
    """

    def __init__(self, hub_params: List[BusParams], link: LinkSpec = None,
                 suppression: bool = True):
        if not hub_params:
            raise ValueError("a fabric needs at least one hub")
        self.hubs = [Hub(i, p) for i, p in enumerate(hub_params)]
        if isinstance(link, dict):
            self._link_params = {tuple(sorted(k)): v for k, v in link.items()}
            self._default_link = LinkParams()
        else:
            self._link_params = {}
            self._default_link = link or LinkParams()
        self._links: Dict[Tuple[int, int], InterHubLink] = {}
        self.suppression = suppression
        self._reset_counters()

    def _reset_counters(self):
        self._down_links = 0      # reset() revives every link (lk.reset())
        self.cross_hub_transfers = 0
        self.suppressed_transfers = 0
        self.suppressed_bytes = 0
        self.suppressed_saved_s = 0.0
        self.wasted_transfers = 0
        self.wasted_bytes = 0

    def reset(self):
        for h in self.hubs:
            h.reset()
        for lk in self._links.values():
            lk.reset()
        self._reset_counters()

    # -- topology -------------------------------------------------------------
    @property
    def n_hubs(self) -> int:
        return len(self.hubs)

    def hub(self, hub_id: int) -> Hub:
        return self.hubs[hub_id]

    def link(self, a: int, b: int) -> InterHubLink:
        key = (a, b) if a <= b else (b, a)
        lk = self._links.get(key)
        if lk is None:
            lk = self._links[key] = InterHubLink(
                key[0], key[1],
                self._link_params.get(key, self._default_link))
        return lk

    # -- link fault state ------------------------------------------------------
    def set_link_state(self, a: int, b: int, up: bool):
        """Mark the ``a<->b`` link up or down.  While down, ``route_cost``
        over it is +inf (so cost-aware dispatch falls back to alternate
        hubs) and ``transfer`` refuses to schedule over it.  In-flight
        transfers are not interrupted: a link fault stops *new* routes."""
        self._route(a, b)
        if a == b:
            raise ValueError("a hub has no link to itself")
        lk = self.link(a, b)
        if lk.up != up:
            lk.up = up
            if not up:
                lk.downs += 1
                self._down_links += 1
            else:
                self._down_links -= 1

    def link_ok(self, a: Optional[int], b: Optional[int]) -> bool:
        """Is the route between these hubs usable?  Local routes (same
        hub, or a missing side) never traverse a link, so always True."""
        if a is None or b is None or a == b:
            return True
        key = (a, b) if a <= b else (b, a)
        lk = self._links.get(key)
        return lk is None or lk.up

    def has_down_links(self) -> bool:
        return self._down_links > 0

    def _route(self, src: Optional[int], dst: Optional[int]) -> Tuple[int, int]:
        """Normalize a (src, dst) pair: a missing side collapses to the
        other (host-local leg), both missing defaults to hub 0.  Hub ids
        are bounds-checked here — every transfer/suppress funnels through
        this, so a bad placement fails loudly instead of wrapping to the
        wrong hub (negative ids) or crashing with a bare IndexError."""
        if src is None:
            src = dst if dst is not None else 0
        if dst is None:
            dst = src
        n = len(self.hubs)
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"unknown hub in route {src}->{dst}: "
                             f"this fabric has hubs 0..{n - 1}")
        return src, dst

    def route_cost(self, src: Optional[int] = None,
                   dst: Optional[int] = None, nbytes: int = 0,
                   t: Optional[float] = None) -> float:
        """Estimated seconds to route ``nbytes`` from ``src`` to ``dst``
        — the dispatch-time toll a fabric-aware ``pick_lane`` folds into
        its completion estimate.

        A local route is one hub-bus transfer; a cross-hub route sums
        its three legs (src egress + link + dst ingress).  With ``t``
        given, each leg also charges its *current FIFO backlog*
        (``free_at - t``): a hot link or saturated destination hub makes
        remote lanes look exactly as expensive as they are right now.
        Legs queue sequentially, so summing the waits is a (cheap,
        slightly pessimistic) upper estimate.  Pure query: no counters
        move, no lazy link is materialized.
        """
        s, d = self._route(src, dst)
        if s == d:
            h = self.hubs[s]
            c = h.local_cost(nbytes)
            if t is not None:
                c += max(h.bus.free_at - t, 0.0)
            return c
        if not self.link_ok(s, d):
            return float("inf")
        hs, hd = self.hubs[s], self.hubs[d]
        c = hs.local_cost(nbytes) + hd.local_cost(nbytes)
        key = (s, d) if s <= d else (d, s)
        lk = self._links.get(key)
        if lk is not None:
            c += lk.cost(nbytes)
            if t is not None:
                c += max(lk.free_at - t, 0.0)
        else:
            p = self._link_params.get(key, self._default_link)
            c += p.overhead_s + nbytes / p.bandwidth
        if t is not None:
            c += max(hs.bus.free_at - t, 0.0) + max(hd.bus.free_at - t, 0.0)
        return c

    def route_legs(self, src: Optional[int], dst: Optional[int],
                   nbytes: int) -> dict:
        """Per-leg nominal cost breakdown of a route, for transfer-span
        annotation (flight recorder).  Pure query like ``route_cost`` —
        no counters move, no lazy link materializes; FIFO waits are
        excluded (the span's own duration already includes them)."""
        s, d = self._route(src, dst)
        if s == d:
            return {"local_s": self.hubs[s].local_cost(nbytes)}
        key = (s, d) if s <= d else (d, s)
        lk = self._links.get(key)
        if lk is not None:
            link_s = lk.cost(nbytes)
        else:
            p = self._link_params.get(key, self._default_link)
            link_s = p.overhead_s + nbytes / p.bandwidth
        return {"egress_s": self.hubs[s].local_cost(nbytes),
                "link_s": link_s,
                "ingress_s": self.hubs[d].local_cost(nbytes)}

    # -- the SharedBus-compatible surface -------------------------------------
    @property
    def bytes_moved(self) -> int:
        return sum(h.bus.bytes_moved for h in self.hubs) + \
            sum(lk.bytes_moved for lk in self._links.values())

    def transfer(self, t_req: float, nbytes: int, n_endpoints: int = 1,
                 src: Optional[int] = None, dst: Optional[int] = None,
                 dst_endpoints: int = 1) -> float:
        """Route a transfer requested at ``t_req``; returns completion.
        Local routes are one hub-bus transfer; cross-hub routes serialize
        egress -> link -> ingress (each leg queues FIFO in its domain)."""
        s, d = self._route(src, dst)
        if s == d:
            return self.hubs[s].bus.transfer(t_req, nbytes, n_endpoints)
        t_egress = self.hubs[s].bus.transfer(t_req, nbytes, n_endpoints)
        t_link = self.link(s, d).transfer(t_egress, nbytes)
        t_ingress = self.hubs[d].bus.transfer(t_link, nbytes, dst_endpoints)
        self.cross_hub_transfers += 1
        return t_ingress

    def suppress(self, nbytes: int, src: Optional[int] = None,
                 dst: Optional[int] = None, t: Optional[float] = None,
                 n_endpoints: int = 1, dst_endpoints: int = 1):
        """Kill a routed handoff before any leg starts.

        With suppression enabled (the default) every domain on the route
        books what it saved: source-hub egress, and — the cross-hub
        stakes — link time plus destination-hub ingress.  Disabled, the
        wasted route is *executed* and charged (the loser's result
        crosses the fabric and is discarded at the host), which is the
        contention baseline the benchmark compares against."""
        if not self.suppression:
            # the wasted route really runs, so it needs a request time —
            # a SharedBus-shaped suppress(nbytes) call must not silently
            # book a phantom transfer
            if t is None:
                raise ValueError(
                    "suppression is disabled on this router: suppress() "
                    "executes the wasted route and needs the request "
                    "time t")
            self.wasted_transfers += 1
            self.wasted_bytes += nbytes
            self.transfer(t, nbytes, n_endpoints, src=src, dst=dst,
                          dst_endpoints=dst_endpoints)
            return
        s, d = self._route(src, dst)
        self.suppressed_transfers += 1
        self.suppressed_bytes += nbytes
        self.hubs[s].bus.suppress(nbytes)
        saved = self.hubs[s].local_cost(nbytes)
        if d != s:
            lk = self.link(s, d)
            lk.suppress(nbytes)
            self.hubs[d].bus.suppress(nbytes)
            saved += lk.cost(nbytes) + self.hubs[d].local_cost(nbytes)
        self.suppressed_saved_s += saved

    def stats(self) -> dict:
        """Aggregate ``SharedBus``-shaped stats plus per-hub and per-link
        breakdowns.  ``suppressed_transfers`` counts router-level
        suppressions once each (the per-domain ledgers in the breakdowns
        count every leg a suppression saved)."""
        hubs = {h.hub_id: h.stats() for h in self.hubs}
        links = {f"{lk.a}<->{lk.b}": lk.stats()
                 for _, lk in sorted(self._links.items())}
        return {
            "bytes_moved": self.bytes_moved,
            "transfers": sum(h.bus.transfers for h in self.hubs) +
            sum(lk.transfers for lk in self._links.values()),
            "busy_s": round(sum(h.bus.busy_s for h in self.hubs) +
                            sum(lk.busy_s for lk in self._links.values()), 6),
            "wait_s": round(sum(h.bus.wait_s for h in self.hubs) +
                            sum(lk.wait_s for lk in self._links.values()), 6),
            "arbitration_s": round(sum(h.bus.arbitration_s_total
                                       for h in self.hubs), 6),
            "wire_s": round(sum(h.bus.wire_s for h in self.hubs) +
                            sum(lk.wire_s for lk in self._links.values()), 6),
            "max_endpoints": max(h.bus.max_endpoints for h in self.hubs),
            "suppressed_transfers": self.suppressed_transfers,
            "suppressed_bytes": self.suppressed_bytes,
            "suppressed_saved_s": round(self.suppressed_saved_s, 6),
            "wasted_transfers": self.wasted_transfers,
            "wasted_bytes": self.wasted_bytes,
            "cross_hub_transfers": self.cross_hub_transfers,
            "down_links": self._down_links,
            "n_hubs": self.n_hubs,
            "hubs": hubs,
            "links": links,
        }


def uniform_fabric(params: BusParams, n_hubs: int,
                   link: Optional[LinkParams] = None,
                   suppression: bool = True) -> FabricRouter:
    """N identical hubs of the given calibration (the common topology:
    the same USB3 hub model, replicated)."""
    return FabricRouter(
        [replace(params, name=f"{params.name}_hub{i}")
         for i in range(n_hubs)],
        link=link, suppression=suppression)
