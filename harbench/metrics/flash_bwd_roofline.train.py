"""Attention's backward least time (five products, 10·B·H·N²·d operations at the bf16
peak) ÷ the device time of the flash dQ and dK/dV kernels in the trace, in %. One
launch of each a block."""
from harbench import counts
from harbench.readers import roofline_pct


def read(run):
    bound = counts.vit_attention(run.cfg, run.workload["batch"])["bwd_bound_s"]
    return roofline_pct(run, r"flash_bwd_(dq|dkv)_kernel", bound, launches_per_unit=2)
