from repro_torch.bus.simulator import (BusParams, SharedBus, TABLE1, calibrated,
                                 calibrate_from_fps, simulate_broadcast_fps)
from repro_torch.bus.fabric import (FabricRouter, Hub, InterHubLink, LinkParams,
                              uniform_fabric)
