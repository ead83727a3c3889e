from repro_torch.runtime.registry import CapabilityRegistry, SlotRecord
from repro_torch.runtime.engine import (ENGINE_CORES, StreamEngine, EngineReport,
                                  validate_chain)
from repro_torch.runtime.events import HeapEventQueue, ListEventQueue
from repro_torch.runtime.lanestate import LaneStateBank, MeterBank, SoABank
from repro_torch.runtime.faults import (FaultEvent, FaultPlan, QuarantinePolicy,
                                  RetryPolicy, frame_checksum)
from repro_torch.runtime.frontdoor import FrontDoor, Tenant, class_name
from repro_torch.runtime.metrics import StreamingHistogram
from repro_torch.runtime.power import PowerGovernor
from repro_torch.runtime.trace import FlightRecorder, MetricsRegistry, jsonable
from repro_torch.runtime.replication import (FLEET_SPLIT, FLEET_TENANTS,
                                       build_battery_engine,
                                       build_chaos_engine,
                                       build_cross_hub_hedge_engine,
                                       build_fabric_engine,
                                       build_fleet_engine,
                                       build_lane_sweep_engine,
                                       build_mixed_engine,
                                       build_replicated_engine,
                                       build_routed_pipeline_engine,
                                       chaos_lane_names,
                                       engine_broadcast_fps,
                                       engine_shard_fps,
                                       fabric_shard_fps,
                                       fleet_capacity_fps,
                                       make_inference_cartridge,
                                       run_battery,
                                       run_chaos,
                                       run_fabric,
                                       run_fleet_sweep,
                                       run_replicated)
from repro_torch.runtime.health import HealthMonitor, QuarantineLedger, quantile
