"""Attention's forward least time (4·B·H·N²·d operations at the bf16 peak) ÷ the flash
forward kernel's device time in the trace, in %. One launch a block."""
from harbench import counts
from harbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, r"flash_attn_kernel", counts.vit_attention(run.cfg, run.workload["batch"])["fwd_bound_s"])
