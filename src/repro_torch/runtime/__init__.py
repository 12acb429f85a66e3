from repro_torch.runtime.ft import (ElasticPlan, HeartbeatMonitor,
                                    StragglerPolicy, compress_int8,
                                    compressed_grad_tree, decompress_int8,
                                    elastic_mesh_shape, plan_rescale)

__all__ = ["HeartbeatMonitor", "StragglerPolicy", "elastic_mesh_shape",
           "plan_rescale", "ElasticPlan", "compress_int8", "decompress_int8",
           "compressed_grad_tree"]
