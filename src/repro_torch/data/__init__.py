from repro_torch.data.pipeline import (DataConfig, FrameStream, Prefetcher,
                                       TokenStream)
