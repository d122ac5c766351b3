"""Model FLOPs of the windows served in the window (counted from the configuration's
shapes, ``counts.fusion_flops``) ÷ the window's seconds ÷ 989 TFLOP/s, in %."""
from harbench.readers import serve_mfu_pct


def read(run):
    return serve_mfu_pct(run)
