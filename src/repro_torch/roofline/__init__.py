"""Roofline analysis of the LM cells (``launch.dryrun``)."""
from repro_torch.roofline.analysis import (CollectiveCounter, RooflineTerms,
                                           active_param_count, model_flops,
                                           roofline_terms,
                                           ssm_time_scan_flops)

__all__ = ["CollectiveCounter", "RooflineTerms", "active_param_count",
           "model_flops", "roofline_terms", "ssm_time_scan_flops"]
