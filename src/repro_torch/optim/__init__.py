from repro_torch.optim.optimizers import (Optimizer, adamw, adafactor,
                                          for_config, clip_by_global_norm,
                                          global_norm, param_count)
from repro_torch.optim.schedules import cosine_warmup, constant
from repro_torch.optim.quant import QTensor, quantize, dequantize
