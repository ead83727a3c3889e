"""Discrete-event shared-bus model (the CHAMP USB3 multi-drop bus).

The bus serializes transfers. Each transfer costs
    base_overhead + arbitration * (n_active_endpoints - 1) + bytes / bandwidth
where the arbitration term models host-side dispatch contention and USB
protocol overhead growing with the number of devices sharing the bus — the
mechanism behind Table 1's per-device FPS decline under broadcast load.

``calibrate_from_fps`` inverts the paper's own measurements: with serial
broadcast (device i's transfer starts after device i-1's) and parallel
on-device compute, the steady-state cycle for N devices is

    cycle(N) = t_comp + N * (t_x + arb * (N - 1))

Three published points (N = 1, 2, 5) pin (t_comp, t_x, arb) exactly; the
remaining table rows validate the fit (tests assert within +-1 FPS).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field


@dataclass
class BusParams:
    name: str
    bandwidth: float = 400e6       # effective B/s (USB3.1 Gen1 practical)
    base_overhead_s: float = 0.0   # per-transfer fixed cost (setup, driver)
    arbitration_s: float = 0.0     # extra cost per competing endpoint
    t_comp_s: float = 0.0          # device compute time (calibrated model)


def calibrate_from_fps(name: str, fps1: float, fps2: float, fps5: float,
                       frame_bytes: int = 150528,
                       bandwidth: float = 400e6) -> BusParams:
    """Solve cycle(N) = t_comp + N*t_x + arb*N*(N-1) through N=1,2,5."""
    c1, c2, c5 = 1.0 / fps1, 1.0 / fps2, 1.0 / fps5
    # c2 - c1 = t_x + 2*arb ; c5 - c1 = 4*t_x + 20*arb
    d2, d5 = c2 - c1, c5 - c1
    arb = (d5 - 4 * d2) / 12.0
    t_x = d2 - 2 * arb
    t_comp = c1 - t_x
    base = max(t_x - frame_bytes / bandwidth, 0.0)
    return BusParams(name=name, bandwidth=bandwidth, base_overhead_s=base,
                     arbitration_s=max(arb, 0.0), t_comp_s=max(t_comp, 0.0))


class SharedBus:
    """FIFO shared bus: transfers serialize; cost grows with contention.

    Contention is accounted explicitly so schedulers can see where bus
    time goes: ``wait_s`` is time transfers spent queued behind the bus
    (FIFO serialization), ``arbitration_s_total`` is protocol overhead
    attributable to the number of endpoints sharing the hub, and
    ``wire_s`` is pure payload time at the calibrated bandwidth.
    """

    def __init__(self, params: BusParams):
        self.p = params
        self.reset()

    def reset(self):
        self.free_at = 0.0
        self.bytes_moved = 0
        self.transfers = 0
        self.busy_s = 0.0
        self.wait_s = 0.0
        self.arbitration_s_total = 0.0
        self.wire_s = 0.0
        self.max_endpoints = 0
        self.suppressed_transfers = 0
        self.suppressed_bytes = 0

    def transfer(self, t_req: float, nbytes: int, n_endpoints: int = 1) -> float:
        """Schedule a transfer requested at ``t_req``; returns completion."""
        start = max(t_req, self.free_at)
        arb = self.p.arbitration_s * max(n_endpoints - 1, 0)
        wire = nbytes / self.p.bandwidth
        dur = self.p.base_overhead_s + arb + wire
        self.free_at = start + dur
        self.bytes_moved += nbytes
        self.transfers += 1
        self.busy_s += dur
        self.wait_s += start - t_req
        self.arbitration_s_total += arb
        self.wire_s += wire
        self.max_endpoints = max(self.max_endpoints, n_endpoints)
        return self.free_at

    def suppress(self, nbytes: int):
        """Account a handoff that was *not* performed: a hedged duplicate
        lost the race after being serviced, so its result never crosses the
        bus.  Suppression is what makes hedging cheap on a shared medium —
        these counters quantify the bus time the cancellation saved."""
        self.suppressed_transfers += 1
        self.suppressed_bytes += nbytes

    def stats(self) -> dict:
        """Contention breakdown of everything moved so far."""
        return {
            "bytes_moved": self.bytes_moved,
            "transfers": self.transfers,
            "busy_s": round(self.busy_s, 6),
            "wait_s": round(self.wait_s, 6),
            "arbitration_s": round(self.arbitration_s_total, 6),
            "wire_s": round(self.wire_s, 6),
            "max_endpoints": self.max_endpoints,
            "suppressed_transfers": self.suppressed_transfers,
            "suppressed_bytes": self.suppressed_bytes,
        }


# ---------------------------------------------------------------------------
# Table 1 broadcast experiment (the paper's only quantitative table)
# ---------------------------------------------------------------------------
def simulate_broadcast_fps(params: BusParams, n_devices: int,
                           frame_bytes: int = 150528,
                           n_frames: int = 200) -> float:
    """Event-driven replication of §4.1: every frame is sent to all N
    devices (serial transfers on the shared bus), all devices infer in
    parallel, next frame dispatches when the slowest finishes."""
    bus = SharedBus(params)
    t = 0.0
    done = 0.0
    for _ in range(n_frames):
        t = max(t, done - 0.0)  # closed loop: dispatch after previous barrier
        finishes = []
        for d in range(n_devices):
            arr = bus.transfer(t, frame_bytes, n_devices)
            finishes.append(arr + params.t_comp_s)
        done = max(finishes)
        t = done
    return n_frames / done


# Published Table 1 rows (FPS for 1..5 devices)
TABLE1 = {
    "ncs2": [15, 13, 10, 8, 6],
    "coral": [25, 22, 19, 17, 15],
}


def calibrated(name: str) -> BusParams:
    row = TABLE1[name]
    return calibrate_from_fps(name, row[0], row[1], row[4])
