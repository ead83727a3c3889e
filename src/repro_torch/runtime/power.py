"""Power/thermal governor: per-hub energy budgets over the dispatch stack.

CHAMP is a *field* architecture: the §4.3 power model (1-2 W per stick
under load, ~0.3 W idle) is a battery budget, not a footnote.  Until now
the reproduction carried ``DeviceModel.power_w``/``idle_w`` as dead
fields; this module makes them load-bearing:

  * **Per-lane energy accounting.**  Every service cycle's *active*
    seconds are charged at ``power_w`` and everything else at ``idle_w``
    — O(1) bookkeeping per cycle (no per-sample state), integrated from
    the same virtual clock the engine runs on.  A lane's energy at time
    ``t`` is exactly::

        E(t) = (t - attached_at) * idle_w + active_s * (power_w - idle_w)

    so a parked (or simply idle) stick still accrues its idle draw —
    unplugging is the only way to zero a device's power, exactly like
    the hardware.

  * **Per-hub watt budgets.**  Each fabric hub may carry a budget
    (``budget_w``); the governor tracks the hub's recent electrical
    draw as an exact exponentially-weighted average (the EWMA ODE has a
    closed form over the piecewise-constant draw the engine produces,
    so the estimate is deterministic and integration-error-free) with
    the hub's thermal time constant (``DeviceModel.therm_tau_s``) as
    the smoothing horizon.

  * **A thermal state machine** per hub::

        nominal --p>budget--> throttled --still over at min duty--> parked
           ^                     |  ^                                  |
           +----p<=exit----------+  +-------------p<=exit-------------+

    *Throttled* hubs duty-cycle their lanes: each service cycle is
    stretched by ``1/duty`` (the stretch is forced idle at ``idle_w``,
    the compute itself is unchanged), with the duty chosen feed-forward
    so the hub's full-load draw lands at ``duty_target * budget`` —
    the margin that pays for the EWMA's ramp-in lag, keeping the
    *average* power under the cap, not just the steady state.
    *Parked* hubs start no new cycles at all (their queued frames wait;
    dispatch routes around them) until the draw estimate cools below
    the exit threshold.  Hysteresis: entry at ``p > budget``, exit at
    ``idle_floor + exit_ratio * (duty_target * budget - idle_floor)``
    — strictly below the throttled steady-state draw, so a throttled
    hub settles instead of flapping, the exit is always reachable by
    cooling, and a draw sitting *exactly at* the budget never flips
    the machine (entry is a strict inequality and the EWMA approaches
    a constant draw from below).  When the required duty falls below
    ``min_duty`` the nominal exit is disabled outright: the hub
    duty-cycles throttled <-> parked rather than celebrating every
    cooldown with a full-draw burst.

  * A budget below the hub's *idle floor* (sum of idle draws) is
    unsatisfiable by scheduling — only unplugging helps.  The governor
    flags it (``unsatisfiable``) and holds the hub at the deepest
    throttle instead of parking forever (a park could never cool below
    the floor, which would deadlock the pipeline).

Broadcast groups are barrier-paced, so their lanes get the feed-forward
duty stretch only (``duty_inflation``) — with no budget configured the
stretch is exactly 1.0 and the Table 1 reproduction is bit-identical.

The governor is always attached to the engine (energy accounting is
free); the state machine only engages when a budget is configured
(``active``), so unbudgeted runs are bit-identical to pre-governor
behavior.

Meter storage is a ``MeterBank`` slab (``runtime.lanestate``): each
``_LaneMeter`` is a thin view over one lane-id-indexed row, so the
report-time energy integral runs as one array expression over the live
fleet instead of a Python loop of scalar formulas (elementwise float64,
bitwise identical per lane).  A detached meter's energy is settled, so
it is frozen into an immutable snapshot and its row recycled.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np

from repro_torch.core.cartridge import DeviceModel
from repro_torch.runtime.lanestate import MeterBank

STATES = ("nominal", "throttled", "parked")

BudgetSpec = Union[None, float, int, Dict[int, float]]


class _LaneMeter:
    """Energy ledger for one physical device (one engine lane) — a view
    over one ``MeterBank`` row, so per-lane energy integrates as array
    math at report time."""

    __slots__ = ("name", "_bank", "_row")

    def __init__(self, name: str, hub: int, dev: DeviceModel, t: float,
                 bank: MeterBank):
        self.name = name
        self._bank = bank
        r = self._row = bank.alloc()
        bank.hub[r] = hub
        bank.power_w[r] = dev.power_w
        bank.idle_w[r] = dev.idle_w
        bank.attached_at[r] = t
        # row defaults: detached_at = -1 (attached), active_s = 0,
        # cycles = 0, uplift_w = 0

    # thin property layer: scalar reads/writes go straight to the row,
    # so the view and the arrays can never disagree
    @property
    def hub(self) -> int:
        return int(self._bank.hub[self._row])

    @hub.setter
    def hub(self, v: int):
        self._bank.hub[self._row] = v

    @property
    def power_w(self) -> float:
        return float(self._bank.power_w[self._row])

    @property
    def idle_w(self) -> float:
        return float(self._bank.idle_w[self._row])

    @property
    def attached_at(self) -> float:
        return float(self._bank.attached_at[self._row])

    @property
    def detached_at(self) -> Optional[float]:
        d = float(self._bank.detached_at[self._row])
        return None if d < 0.0 else d

    @detached_at.setter
    def detached_at(self, v: Optional[float]):
        self._bank.detached_at[self._row] = -1.0 if v is None else v

    @property
    def active_s(self) -> float:
        return float(self._bank.active_s[self._row])

    @active_s.setter
    def active_s(self, v: float):
        self._bank.active_s[self._row] = v

    @property
    def cycles(self) -> int:
        return int(self._bank.cycles[self._row])

    @cycles.setter
    def cycles(self, v: int):
        self._bank.cycles[self._row] = v

    @property
    def _uplift_w(self) -> float:
        return float(self._bank.uplift_w[self._row])

    @_uplift_w.setter
    def _uplift_w(self, v: float):
        self._bank.uplift_w[self._row] = v

    def elapsed(self, t: float) -> float:
        end = self.detached_at if self.detached_at is not None else t
        return max(end - self.attached_at, 0.0)

    def energy_j(self, t: float) -> float:
        return self.elapsed(t) * self.idle_w + \
            self.active_s * (self.power_w - self.idle_w)

    def freeze(self) -> "_FrozenMeter":
        """Snapshot a detached meter and recycle its slab row."""
        f = _FrozenMeter(self)
        self._bank.release(self._row)
        return f

    def summary(self, t: float, energy: Optional[float] = None) -> dict:
        el = self.elapsed(t)
        e = self.energy_j(t) if energy is None else energy
        return {
            "hub": self.hub,
            "active_s": round(self.active_s, 6),
            "cycles": self.cycles,
            "active_j": round(self.active_s * self.power_w, 6),
            "idle_j": round(max(el - self.active_s, 0.0) * self.idle_w, 6),
            "energy_j": round(e, 6),
            "avg_w": round(e / el, 4) if el > 0 else 0.0,
            "detached": self.detached_at is not None,
        }


class _FrozenMeter:
    """Immutable snapshot of a detached meter.  Once ``detached_at`` is
    set the meter's energy no longer depends on ``t``, so the snapshot
    precomputes it and the live bank row can be recycled."""

    __slots__ = ("name", "hub", "power_w", "idle_w", "active_s", "cycles",
                 "_elapsed", "_energy")

    def __init__(self, m: _LaneMeter):
        self.name = m.name
        self.hub = m.hub
        self.power_w = m.power_w
        self.idle_w = m.idle_w
        self.active_s = m.active_s
        self.cycles = m.cycles
        self._elapsed = m.elapsed(0.0)   # detached: t-independent
        self._energy = m.energy_j(0.0)

    def elapsed(self, t: float) -> float:
        return self._elapsed

    def energy_j(self, t: float) -> float:
        return self._energy

    def summary(self, t: float) -> dict:
        el = self._elapsed
        e = self._energy
        return {
            "hub": self.hub,
            "active_s": round(self.active_s, 6),
            "cycles": self.cycles,
            "active_j": round(self.active_s * self.power_w, 6),
            "idle_j": round(max(el - self.active_s, 0.0) * self.idle_w, 6),
            "energy_j": round(e, 6),
            "avg_w": round(e / el, 4) if el > 0 else 0.0,
            "detached": True,
        }


class _HubState:
    """One hub's draw estimate + thermal state machine."""

    __slots__ = ("hub", "budget_w", "state", "last_t", "draw_w", "p_hat",
                 "tau", "min_duty", "idle_floor_w", "active_ceiling_w",
                 "duty", "throttle_events", "park_events", "throttled_s",
                 "parked_s", "unsatisfiable")

    def __init__(self, hub: int, budget_w: Optional[float]):
        self.hub = hub
        self.budget_w = budget_w
        self.state = "nominal"
        self.last_t = 0.0
        self.draw_w = 0.0              # running cycles' draw above idle
        self.p_hat = 0.0               # EWMA of floor + draw_w (thermal est)
        self.tau = 1.0
        self.min_duty = 0.2
        self.idle_floor_w = 0.0
        self.active_ceiling_w = 0.0
        self.duty = 1.0
        self.throttle_events = 0
        self.park_events = 0
        self.throttled_s = 0.0
        self.parked_s = 0.0
        self.unsatisfiable = False

    def inflation(self) -> float:
        return 1.0 if self.state == "nominal" else 1.0 / self.duty


class PowerGovernor:
    """Always-on energy meter + optional per-hub budget enforcement.

    ``budget_w`` may be a scalar (the same cap on every hub — the
    common battery-kit case), a ``{hub_id: watts}`` dict (hubs absent
    from the dict are uncapped), or ``None`` (metering only).
    """

    def __init__(self, budget_w: BudgetSpec = None, *,
                 exit_ratio: float = 0.85, duty_target: float = 0.92,
                 park_duty_floor: Optional[float] = None):
        if isinstance(budget_w, dict):
            for h, w in budget_w.items():
                if w is not None and w <= 0:
                    raise ValueError(f"hub {h} budget must be > 0, got {w}")
        elif budget_w is not None and budget_w <= 0:
            raise ValueError(f"power budget must be > 0, got {budget_w}")
        if not 0.0 < exit_ratio < 1.0:
            raise ValueError("exit_ratio must be in (0, 1)")
        if not 0.0 < duty_target <= 1.0:
            raise ValueError("duty_target must be in (0, 1]")
        self._budget = budget_w
        self.exit_ratio = exit_ratio
        self.duty_target = duty_target
        self.park_duty_floor = park_duty_floor   # None -> per-device field
        self._bank = MeterBank()                     # meter state arrays
        self._lanes: Dict[int, _LaneMeter] = {}      # id(cart) -> meter
        self._lane_dev: Dict[int, DeviceModel] = {}  # id(cart) -> device
        self._retired: Dict[str, _FrozenMeter] = {}  # name -> snapshot
        self._hubs: Dict[int, _HubState] = {}
        # optional FlightRecorder: state transitions emit power.state
        # instants (the engine wires this when tracing is enabled)
        self.tracer = None

    # -- configuration --------------------------------------------------------
    @property
    def active(self) -> bool:
        """Whether any budget is configured (state machine engaged)."""
        if isinstance(self._budget, dict):
            return any(w is not None for w in self._budget.values())
        return self._budget is not None

    def budget_of(self, hub: int) -> Optional[float]:
        if isinstance(self._budget, dict):
            return self._budget.get(hub)
        return self._budget

    def set_budget(self, budget_w: BudgetSpec, t: float = 0.0):
        """Re-budget at runtime (battery saver kicking in mid-mission).
        Existing hub states re-evaluate against the new cap at their
        next touch."""
        self._budget = budget_w
        for hs in self._hubs.values():
            hs.budget_w = self.budget_of(hs.hub)
            # a cap dropped below the idle floor is unsatisfiable from
            # this moment on — it must take the deepest-duty hold, not
            # the park path (which could never cool below the floor)
            hs.unsatisfiable = (hs.budget_w is not None
                                and hs.idle_floor_w > hs.budget_w)
            self._advance(hs, t)
            self._evaluate(hs)

    # -- lane population ------------------------------------------------------
    def _hub_state(self, hub: int) -> _HubState:
        hs = self._hubs.get(hub)
        if hs is None:
            hs = self._hubs[hub] = _HubState(hub, self.budget_of(hub))
        return hs

    def _recalibrate(self, hs: _HubState):
        """Re-derive the hub's thermal constants from its population."""
        lanes = [m for m in self._lanes.values()
                 if m.hub == hs.hub and m.detached_at is None]
        hs.idle_floor_w = sum(m.idle_w for m in lanes)
        hs.active_ceiling_w = sum(m.power_w for m in lanes)
        if lanes:
            devs = [self._lane_dev[k] for k, m in self._lanes.items()
                    if m.hub == hs.hub and m.detached_at is None]
            hs.tau = max(d.therm_tau_s for d in devs)
            hs.min_duty = self.park_duty_floor if self.park_duty_floor \
                is not None else min(d.min_duty for d in devs)
        # a hub never draws below its idle floor while sticks are plugged:
        # seed/raise the estimate so a cold hub starts at idle, not zero
        hs.p_hat = max(hs.p_hat, hs.idle_floor_w)
        hs.unsatisfiable = (hs.budget_w is not None
                            and hs.idle_floor_w > hs.budget_w)

    def sync(self, t: float, population: Dict[int, tuple]):
        """Reconcile with the engine's live lane set after a rebuild.
        ``population`` maps ``id(cartridge) -> (name, DeviceModel, hub)``."""
        touched = set()
        for key, (name, dev, hub) in population.items():
            m = self._lanes.get(key)
            if m is None:
                m = self._lanes[key] = _LaneMeter(name, hub, dev, t,
                                                  self._bank)
                self._lane_dev[key] = dev
                touched.add(hub)
            elif m.hub != hub:           # re-plugged onto another hub
                touched.add(m.hub)
                touched.add(hub)
                hs_old = self._hub_state(m.hub)
                self._advance(hs_old, t)
                hs_old.draw_w -= m._uplift_w
                m._uplift_w = 0.0
                m.hub = hub
        for key, m in list(self._lanes.items()):
            if key not in population and m.detached_at is None:
                m.detached_at = t
                hub = m.hub          # capture before freeze releases the row
                hs = self._hub_state(hub)
                self._advance(hs, t)
                hs.draw_w -= m._uplift_w
                m._uplift_w = 0.0
                self._retired[m.name] = m.freeze()
                del self._lanes[key]
                del self._lane_dev[key]
                touched.add(hub)
        for hub in touched:
            hs = self._hub_state(hub)
            self._advance(hs, t)
            self._recalibrate(hs)
            self._evaluate(hs)

    # -- draw integration -----------------------------------------------------
    def _advance(self, hs: _HubState, t: float):
        """Advance the hub's EWMA draw estimate to ``t``.  The draw —
        idle floor plus the running cycles' uplift — is piecewise
        constant between engine events, so the EWMA update is the exact
        solution of dp/dt = (draw - p)/tau over the interval."""
        dt = t - hs.last_t
        if dt <= 0.0:
            return
        draw = hs.idle_floor_w + hs.draw_w
        hs.p_hat += (draw - hs.p_hat) * (1.0 - math.exp(-dt / hs.tau))
        if hs.state == "throttled":
            hs.throttled_s += dt
        elif hs.state == "parked":
            hs.parked_s += dt
        hs.last_t = t

    def _evaluate(self, hs: _HubState):
        """Run the state machine against the current draw estimate.
        With a tracer attached, any state transition emits a
        ``power.state`` instant (at ``hs.last_t``, the virtual time the
        estimate was advanced to) — the machine itself is untouched, so
        traced runs stay float-for-float identical."""
        prev = hs.state
        self._step_state(hs)
        if self.tracer is not None and hs.state != prev:
            self.tracer.instant(
                "power.state", hs.last_t, track=f"hub{hs.hub}",
                state=hs.state, prev=prev, p_hat_w=hs.p_hat,
                duty=hs.duty)

    def _step_state(self, hs: _HubState):
        b = hs.budget_w
        if b is None:
            hs.state = "nominal"
            hs.duty = 1.0
            return
        span = hs.active_ceiling_w - hs.idle_floor_w
        if span <= 0.0:                  # empty hub (or zero-draw devices)
            hs.state = "nominal"
            hs.duty = 1.0
            return
        target = b * self.duty_target
        d_req = (target - hs.idle_floor_w) / span
        hs.duty = min(max(d_req, hs.min_duty), 1.0)
        # exit strictly below the throttle *target* (the draw a throttled
        # hub settles at), proportionally to its headroom over the idle
        # floor — so the throttled steady state never re-crosses the exit
        # and the machine cannot oscillate on a constant load
        exit_w = hs.idle_floor_w + self.exit_ratio * \
            max(target - hs.idle_floor_w, 0.0)
        if hs.unsatisfiable:
            # idle draw alone busts the cap: parking cannot cool below
            # the floor, so hold the deepest duty cycle and keep moving
            if hs.state != "throttled":
                hs.state = "throttled"
                hs.throttle_events += 1
            hs.duty = hs.min_duty
            return
        if hs.state == "nominal":
            if hs.p_hat > b:
                hs.state = "throttled"
                hs.throttle_events += 1
        elif hs.state == "throttled":
            if hs.p_hat <= exit_w and d_req >= hs.min_duty:
                # only drop the throttle when an untrottled burst could
                # ever be re-contained: if the budget needs a duty below
                # the floor, the hub duty-cycles throttled <-> parked
                # instead of bursting at full draw
                hs.state = "nominal"
                hs.duty = 1.0
            elif d_req < hs.min_duty and hs.p_hat > b:
                # even the deepest duty cycle cannot hold the cap with
                # lanes running: stop starting cycles until it cools
                hs.state = "parked"
                hs.park_events += 1
        elif hs.state == "parked":
            if hs.p_hat <= exit_w:
                hs.state = "throttled"

    # -- engine hooks (O(1) each) ---------------------------------------------
    def on_cycle_start(self, t: float, cart, dur_s: float, active_s: float):
        """A shard-lane service cycle begins: charge its nominal compute
        (``active_s``) now and raise the hub draw for ``dur_s`` (the
        possibly duty-stretched occupancy)."""
        m = self._lanes.get(id(cart))
        if m is None:
            return
        m.active_s += active_s
        m.cycles += 1
        if not self.active or dur_s <= 0.0:
            return
        hs = self._hub_state(m.hub)
        self._advance(hs, t)
        # average draw above idle over the (stretched) cycle: the active
        # fraction runs at power_w, the forced-idle remainder at idle_w
        uplift = (active_s / dur_s) * (m.power_w - m.idle_w)
        m._uplift_w += uplift
        hs.draw_w += uplift
        self._evaluate(hs)

    def on_cycle_end(self, t: float, cart):
        m = self._lanes.get(id(cart))
        if m is None:
            return
        # settle the uplift even if the budget was dropped mid-cycle
        # (set_budget(None) while a lane is in service): leaving it in
        # draw_w would haunt the estimate as a phantom permanent load
        if not self.active and m._uplift_w == 0.0:
            return
        hs = self._hub_state(m.hub)
        self._advance(hs, t)
        hs.draw_w -= m._uplift_w
        m._uplift_w = 0.0
        self._evaluate(hs)

    def on_window(self, t: float, cart, dur_s: float, active_s: float):
        """A broadcast service window was scheduled (it may start in the
        future — barrier pacing): charge its compute energy in one lump.
        Broadcast draw stays out of the EWMA feedback loop; broadcast
        hubs are governed feed-forward via ``duty_inflation``."""
        m = self._lanes.get(id(cart))
        if m is None:
            return
        m.active_s += active_s
        m.cycles += 1

    # -- dispatch-facing queries ----------------------------------------------
    def inflation(self, t: float, hub: int) -> float:
        """Service-time stretch for a shard cycle starting on ``hub`` now
        (also the dispatch-estimate multiplier: a throttled lane looks
        proportionally slower to ``pick_lane``)."""
        if not self.active:
            return 1.0
        hs = self._hub_state(hub)
        self._advance(hs, t)
        self._evaluate(hs)
        return hs.inflation()

    def duty_inflation(self, t: float, hub: int) -> float:
        """Feed-forward stretch for barrier-paced (broadcast) lanes:
        population-derived duty, no EWMA feedback.  1.0 when the hub is
        unbudgeted — Table 1 parity is bit-exact."""
        b = self.budget_of(hub)
        if b is None:
            return 1.0
        hs = self._hub_state(hub)
        self._advance(hs, t)
        span = hs.active_ceiling_w - hs.idle_floor_w
        if span <= 0.0:
            return 1.0
        d = (b * self.duty_target - hs.idle_floor_w) / span
        d = min(max(d, hs.min_duty), 1.0)
        return 1.0 / d

    def tau_of(self, hub: int) -> float:
        """The hub's thermal time constant (control horizon)."""
        hs = self._hubs.get(hub)
        return hs.tau if hs is not None else 1.0

    def parked(self, t: float, hub: int) -> bool:
        if not self.active:
            return False
        hs = self._hub_state(hub)
        self._advance(hs, t)
        self._evaluate(hs)
        return hs.state == "parked"

    def unpark_eta(self, t: float, hub: int) -> float:
        """When a parked hub's draw estimate will cross its exit
        threshold, from the closed-form EWMA decay toward the current
        draw.  Conservative fallback (one thermal horizon) while cycles
        are still draining."""
        hs = self._hub_state(hub)
        self._advance(hs, t)
        b = hs.budget_w
        if b is None or hs.state != "parked":
            return t
        exit_w = hs.idle_floor_w + self.exit_ratio * \
            max(b * self.duty_target - hs.idle_floor_w, 0.0)
        if hs.p_hat <= exit_w:
            return t
        draw = hs.idle_floor_w + hs.draw_w
        if draw >= exit_w:               # in-flight cycles still drawing
            return t + hs.tau
        eta = hs.tau * math.log((hs.p_hat - draw) / (exit_w - draw))
        return t + max(eta, 0.0)

    # -- reporting ------------------------------------------------------------
    def report(self, t: float) -> dict:
        """Energy/throttle breakdown at time ``t`` (idempotent; the
        engine calls this at the end of every ``run``)."""
        lanes = {}
        hub_energy: Dict[int, float] = {}
        hub_lanes: Dict[int, int] = {}
        # live meter joules: one array expression over the slab rows;
        # elementwise float64 → each value is bitwise equal to the scalar
        # energy_j, and per-hub totals still accumulate in meter order
        live = list(self._lanes.values())
        if live:
            rows = np.fromiter((m._row for m in live), dtype=np.int64,
                               count=len(live))
            live_e = self._bank.energy(t, rows)
        else:
            live_e = ()
        # retired first: a re-used name reports the live lane's ledger
        for m in self._retired.values():
            lanes[m.name] = m.summary(t)
            hub_energy[m.hub] = hub_energy.get(m.hub, 0.0) + m.energy_j(t)
            hub_lanes[m.hub] = hub_lanes.get(m.hub, 0) + 1
        for m, ev in zip(live, live_e):
            e = float(ev)
            lanes[m.name] = m.summary(t, energy=e)
            hub_energy[m.hub] = hub_energy.get(m.hub, 0.0) + e
            hub_lanes[m.hub] = hub_lanes.get(m.hub, 0) + 1
        hubs = {}
        for hub in sorted(set(hub_energy) | set(self._hubs)):
            hs = self._hubs.get(hub)
            if hs is not None:
                self._advance(hs, t)
                self._evaluate(hs)
            e = hub_energy.get(hub, 0.0)
            el = t  # hub clock starts with the engine
            hubs[hub] = {
                "energy_j": round(e, 6),
                "avg_w": round(e / el, 4) if el > 0 else 0.0,
                "lanes": hub_lanes.get(hub, 0),
                "budget_w": self.budget_of(hub),
                "state": hs.state if hs is not None else "nominal",
                "p_hat_w": round(hs.p_hat, 4) if hs is not None else 0.0,
                "idle_floor_w": round(hs.idle_floor_w, 4)
                if hs is not None else 0.0,
                "inflation": round(hs.inflation(), 4)
                if hs is not None else 1.0,
                "throttle_events": hs.throttle_events
                if hs is not None else 0,
                "park_events": hs.park_events if hs is not None else 0,
                "throttled_s": round(hs.throttled_s, 6)
                if hs is not None else 0.0,
                "parked_s": round(hs.parked_s, 6)
                if hs is not None else 0.0,
                "unsatisfiable": hs.unsatisfiable
                if hs is not None else False,
            }
        total = sum(hub_energy.values())
        return {
            "lanes": lanes,
            "hubs": hubs,
            "total_j": round(total, 6),
            "avg_w": round(total / t, 4) if t > 0 else 0.0,
            "governed": self.active,
        }
