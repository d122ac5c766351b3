"""3 × the forward FLOPs a sample (``counts.train_step_flops``) × the samples of the
steps done in the window ÷ its seconds ÷ 989 TFLOP/s, in %."""
from harbench.readers import train_mfu_pct


def read(run):
    return train_mfu_pct(run)
