from repro_torch.roofline.analysis import (HW_H100, Hardware, model_flops,
                                           roofline_terms, two_point_fit)

__all__ = ["HW_H100", "Hardware", "model_flops", "roofline_terms",
           "two_point_fit"]
