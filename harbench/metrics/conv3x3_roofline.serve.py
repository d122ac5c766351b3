"""The fused bf16 residual convs' least time (2·M·9·C·C_out operations; input,
weights, residual and output bytes once; ``counts.conv3x3_forward``) ÷ their device
time in the trace, in %. A forward launches one per conv."""
from harbench import counts
from harbench.readers import roofline_pct


def read(run):
    per = counts.conv3x3_forward(run.cfg, run.workload["batch"])
    return roofline_pct(run, r"conv3x3_bn_act_kernel", per["bound_s"] / per["launches"])
