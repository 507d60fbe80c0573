from repro_torch.roofline.analysis import (HW_H100, CollectiveStats,
                                           Hardware, collective_stats,
                                           model_flops, roofline_terms,
                                           two_point_fit)

__all__ = ["HW_H100", "CollectiveStats", "Hardware", "collective_stats",
           "model_flops", "roofline_terms", "two_point_fit"]
