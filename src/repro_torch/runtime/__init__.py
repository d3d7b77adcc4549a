from repro_torch.runtime.compression import (ErrorFeedback, int8_dequantize,
                                             int8_quantize, topk_compress,
                                             topk_decompress)
from repro_torch.runtime.elastic import ElasticPlan, plan_mesh
from repro_torch.runtime.health import HeartbeatMonitor, HostState

__all__ = ["HeartbeatMonitor", "HostState", "plan_mesh", "ElasticPlan",
           "topk_compress", "topk_decompress", "int8_quantize",
           "int8_dequantize", "ErrorFeedback"]
