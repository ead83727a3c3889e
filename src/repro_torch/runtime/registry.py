"""Capability registry — VDiSK's view of what is plugged into the bus.

Mirrors the paper's §3.2 handshake: on insertion a cartridge reports its
capability ID and data format; the registry records it and notifies
listeners (the engine rebuilds its pipeline routing on these events, the
way VDiSK reacts to USB attach/detach + Zeroconf announcements).

A slot is a *lane group*: it may hold several replica cartridges of the
same capability (the paper's §4.1 broadcast experiment plugs up to five
identical accelerators into one hub).  ``SlotRecord.replicas`` lists every
physical device backing the slot; ``SlotRecord.cartridge`` stays the
primary replica for backward compatibility.  ``mode`` selects how the
engine dispatches over the replicas:

  * ``"shard"``     — frames are load-balanced across replicas
                      (throughput scaling);
  * ``"broadcast"`` — every frame goes to every replica (Table 1's
                      redundant-inference experiment).

Replicas need not be the same accelerator type: a slot may mix e.g. one
NCS2 with two Corals (heterogeneous lane group) as long as every replica
speaks the primary's contract.  The engine's weighted dispatcher reads
each replica's ``DeviceModel`` as its service-time seed, so a slow stick
carries proportionally less of the slot's load instead of gating it.

Hub placement (multi-hub fabric).  Each physical device plugs into one
hub of the bus fabric; ``insert`` / ``add_replica`` take a ``hub`` id
(default: hub 0 / the primary's hub) and the registry tracks the
device -> hub map, so lane groups can *span* hubs and the engine's
router can charge each transfer to the right arbitration domain
(``n_endpoints`` contention is per hub, not fleet-wide).

Quorum broadcast.  A ``broadcast`` slot may carry ``quorum=k``: the
engine decides each frame at the k-th replica completion instead of the
slowest, suppressing the stragglers' result handoffs — Table 1
redundancy at shard-like tails.  ``quorum=None`` (or ``k >= N``) is the
paper's full-barrier semantics, bit-identical to Table 1.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.cartridge import Cartridge

DISPATCH_MODES = ("shard", "broadcast")


@dataclass
class SlotRecord:
    slot: int
    cartridge: Cartridge              # primary replica (compat accessor)
    handshake: dict
    inserted_at: float = 0.0
    mode: str = "shard"
    replicas: List[Cartridge] = field(default_factory=list)
    quorum: Optional[int] = None      # broadcast: first k of N results win

    def __post_init__(self):
        if not self.replicas:
            self.replicas = [self.cartridge]

    def devices(self) -> List[str]:
        """Accelerator type of each replica lane, in lane order."""
        return [c.device.name for c in self.replicas]

    def heterogeneous(self) -> bool:
        """True when the slot mixes accelerator types (or calibrations)."""
        return len({(c.device.name, c.device.service_s)
                    for c in self.replicas}) > 1


def _compatible_replica(primary: Cartridge, cart: Cartridge) -> bool:
    """A replica must speak the primary's exact contract (same capability,
    interchangeable consume/produce specs) or the dispatcher could route a
    frame to a device that cannot process it."""
    return (cart.capability_id == primary.capability_id
            and cart.consumes.accepts(primary.consumes)
            and primary.consumes.accepts(cart.consumes)
            and cart.produces.accepts(primary.produces)
            and primary.produces.accepts(cart.produces))


class CapabilityRegistry:
    def __init__(self):
        self.slots: Dict[int, SlotRecord] = {}
        self._listeners: List[Callable[[str, SlotRecord], None]] = []
        self._hub_of: Dict[int, int] = {}    # id(cartridge) -> hub id
        self._hub_counts: Dict[int, int] = {}  # hub id -> plugged devices
        self._failed: set = set()            # id(cartridge), powered off
        self._failed_on: Dict[int, int] = {}  # hub id -> failed devices

    def _hub_plug(self, cart: Cartridge, hub: int):
        self._hub_of[id(cart)] = hub
        self._hub_counts[hub] = self._hub_counts.get(hub, 0) + 1

    def _hub_unplug(self, cart: Cartridge):
        if id(cart) in self._failed:         # unplugging clears fault state
            self.set_failed(cart, False)
        hub = self._hub_of.pop(id(cart), None)
        if hub is not None:
            n = self._hub_counts.get(hub, 0) - 1
            if n > 0:
                self._hub_counts[hub] = n
            else:
                self._hub_counts.pop(hub, None)

    # -- discovery events ----------------------------------------------------
    def insert(self, slot: int, cart: Cartridge, t: float = 0.0,
               mode: str = "shard", hub: int = 0,
               quorum: Optional[int] = None) -> SlotRecord:
        if slot in self.slots:
            raise ValueError(f"slot {slot} occupied by "
                             f"{self.slots[slot].cartridge.name}")
        if mode not in DISPATCH_MODES:
            raise ValueError(f"unknown dispatch mode {mode!r}")
        if quorum is not None:
            if mode != "broadcast":
                raise ValueError("quorum only applies to broadcast slots")
            if quorum < 1:
                raise ValueError(f"quorum must be >= 1, got {quorum}")
        rec = SlotRecord(slot, cart, cart.handshake(), inserted_at=t,
                         mode=mode, quorum=quorum)
        self.slots[slot] = rec
        self._hub_plug(cart, hub)
        for fn in self._listeners:
            fn("insert", rec)
        return rec

    def remove(self, slot: int, t: float = 0.0) -> SlotRecord:
        rec = self.slots.pop(slot, None)
        if rec is None:
            raise ValueError(
                f"slot {slot} is not occupied; plugged slots: "
                f"{sorted(self.slots) or 'none'}")
        for cart in rec.replicas:
            self._hub_unplug(cart)
        for fn in self._listeners:
            fn("remove", rec)
        return rec

    def add_replica(self, slot: int, cart: Cartridge,
                    t: float = 0.0, hub: Optional[int] = None) -> SlotRecord:
        """Plug an additional device of the slot's capability into a hub
        (default: the primary's hub; pass ``hub=`` to span the fabric)."""
        rec = self.slots[slot]
        for other in self.slots.values():
            if cart in other.replicas:
                raise ValueError(
                    f"{cart.name} is already plugged into slot "
                    f"{other.slot}; clone() it for another physical device")
        if not _compatible_replica(rec.cartridge, cart):
            raise ValueError(
                f"replica {cart.name} incompatible with slot {slot} "
                f"({rec.cartridge.name}: "
                f"{rec.cartridge.consumes.describe()}->"
                f"{rec.cartridge.produces.describe()})")
        rec.replicas.append(cart)
        self._hub_plug(cart, hub if hub is not None
                       else self.hub_of(rec.cartridge))
        for fn in self._listeners:
            fn("add_replica", rec)
        return rec

    def remove_replica(self, slot: int, cart: Optional[Cartridge] = None,
                       t: float = 0.0) -> SlotRecord:
        """Unplug one replica.  Removing the last replica removes the slot
        (equivalent to ``remove``, with its bridge/halt consequences)."""
        rec = self.slots.get(slot)
        if rec is None:
            raise ValueError(
                f"slot {slot} is not occupied; plugged slots: "
                f"{sorted(self.slots) or 'none'}")
        victim = cart if cart is not None else rec.replicas[-1]
        if victim not in rec.replicas:
            raise ValueError(f"{victim.name} not a replica of slot {slot}")
        if len(rec.replicas) == 1:
            return self.remove(slot, t)
        rec.replicas.remove(victim)
        self._hub_unplug(victim)
        if rec.cartridge is victim:          # promote a surviving replica
            rec.cartridge = rec.replicas[0]
            rec.handshake = rec.cartridge.handshake()
        for fn in self._listeners:
            fn("remove_replica", rec)
        return rec

    def subscribe(self, fn: Callable[[str, SlotRecord], None]):
        self._listeners.append(fn)

    # -- queries --------------------------------------------------------------
    def chain(self) -> List[Cartridge]:
        """Primary cartridges in physical slot order (the paper's default
        pipeline; replicas share the primary's contract)."""
        return [self.slots[s].cartridge for s in sorted(self.slots)]

    def records(self) -> List[SlotRecord]:
        """Slot records in physical slot order (one per lane group)."""
        return [self.slots[s] for s in sorted(self.slots)]

    def n_replicas(self, slot: int) -> int:
        return len(self.slots[slot].replicas)

    def slot_devices(self, slot: int) -> List[str]:
        """Per-lane accelerator types backing a slot (dispatch telemetry)."""
        return self.slots[slot].devices()

    def n_endpoints(self) -> int:
        """Total *powered* devices on the bus (arbitration contention).
        A crashed or powered-off device stops arbitrating, so failed
        lanes are excluded — chaos runs see contention relax exactly as
        real hardware would."""
        return sum(len(r.replicas) for r in self.slots.values()) \
            - len(self._failed)

    # -- fault state (chaos fabric) -------------------------------------------
    def set_failed(self, cart: Cartridge, failed: bool = True):
        """Mark a plugged device failed (crashed / hub power loss) or
        recovered.  Failed devices stay *plugged* — the slot still owns
        them and reinstatement is cheap — but they leave the arbitration
        counts: a dead stick neither drives nor arbitrates the bus."""
        key = id(cart)
        hub = self._hub_of.get(key)
        if hub is None:
            raise ValueError(f"{cart.name} is not plugged in")
        if failed and key not in self._failed:
            self._failed.add(key)
            self._failed_on[hub] = self._failed_on.get(hub, 0) + 1
        elif not failed and key in self._failed:
            self._failed.discard(key)
            n = self._failed_on.get(hub, 1) - 1
            if n > 0:
                self._failed_on[hub] = n
            else:
                self._failed_on.pop(hub, None)

    def is_failed(self, cart: Cartridge) -> bool:
        return id(cart) in self._failed

    def n_failed(self) -> int:
        return len(self._failed)

    # -- hub placement (multi-hub fabric) -------------------------------------
    def hub_of(self, cart: Cartridge) -> int:
        """Which fabric hub a device is plugged into (default hub 0)."""
        return self._hub_of.get(id(cart), 0)

    def n_endpoints_on(self, hub: int) -> int:
        """Powered devices sharing one hub's arbitration domain — the
        contention count a hub-partitioned fabric charges per transfer.
        O(1): the engine asks for this several times per handoff."""
        return self._hub_counts.get(hub, 0) - self._failed_on.get(hub, 0)

    def hubs(self) -> List[int]:
        """Hub ids with at least one plugged device, sorted."""
        return sorted(self._hub_counts)

    def find(self, capability_id: int) -> Optional[Cartridge]:
        for rec in self.slots.values():
            if rec.handshake["capability_id"] == capability_id:
                return rec.cartridge
        return None
